"""The harness: registry, counts, peaks, trace reading, seeded inputs."""
