#!/usr/bin/env python3
"""Mutation check of ``chip_smoke.py`` for the flat trunk's (both paths of
``flatconv.cu``), the pool's, the 3x3 weight gradient's (``wgrad.cu``), the
stem conv's (``stem.cu``, ``stem_wgrad.cu``'s two paths and the
``stem.cuh`` they share), the fused-head tail's (``fused_head.cu``), the
CB-BCE statistics' (``cbbce.cu``) and the int8 conv's (``int8conv.cu``)
kernels, and of ``make_dot``'s graph walk behind ``--vis_net``.

    python3 tools/mutation_check.py [name prefix ...]

With prefixes, only the mutants whose names start with one of them run
(``python3 tools/mutation_check.py int8`` runs the int8 conv's, ``int8q_``
those of its Hopper path, ``pk_`` the five of the packed schedule: a
sequence launch of B17 reading sequence 0 for every sequence, B16's
sequence gather reading the next sequence's channels, the sequence-major
block decode handing two sequences one index, the loss meaned over all the
rows, the mesh's pads kept (``pk_seq`` the first three, which the card tests
catch); ``vis_`` the one of
``utils/visualize.py``, a parameter leaf left out of the drawn graph, which
phase 8b catches).

Run from the root of a checkout on a machine with an NVIDIA H100. For each
mutant below, the checkout is copied to ``build/mutants/<name>`` (``build/``
is in ``.gitignore``), one fault is written into a kernel source (or a
``parallel/`` module, or ``utils/visualize.py``) of the copy, and ``chip_smoke.py`` runs there. Every mutant must make it exit
nonzero; the script prints each exit code and the check that failed, and
exits nonzero itself if a mutant survived.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAT = "osvos_torch/csrc/flatconv.cu"
WGRAD = "osvos_torch/csrc/wgrad.cu"
POOL = "osvos_torch/csrc/pool.cu"
STEM = "osvos_torch/csrc/stem_wgrad.cu"
STEM_FWD = "osvos_torch/csrc/stem.cu"
STEM_H = "osvos_torch/csrc/stem.cuh"
HOPPER_H = "osvos_torch/csrc/hopper.cuh"
TAIL = "osvos_torch/csrc/fused_head.cu"
CBBCE = "osvos_torch/csrc/cbbce.cu"
INT8 = "osvos_torch/csrc/int8conv.cu"
BATCHED = "osvos_torch/parallel/batched_online.py"
PACKED = "osvos_torch/parallel/packed.py"
MESH = "osvos_torch/parallel/mesh.py"
VIS = "osvos_torch/utils/visualize.py"

# name -> (file, text, replacement): one fault each
MUTANTS = {
    # B3's route (the pool backward, B10's kernel): a tied pixel after the
    # first also takes the pooled cotangent
    "b3_tie_order": (POOL, "const bool wins = !taken[e] && f32(v.v[e]) == f32(m.v[e]);",
                     "const bool wins = f32(v.v[e]) == f32(m.v[e]);"),
    # B3 and B6 (the mma path's dz, the odd C = 12 cases): the producer's
    # ReLU backward left out
    "dz_relu_mask": (FLAT, "v[e] = zv > 0.f ? v[e] : 0.f;", "v[e] = v[e];"),
    # B2 on the mma path (the stem at D = 12, the odd C = 12 case): the bias
    # added after a bf16 rounding of the sum
    "b2_bias_after_rounding": (
        FLAT, "const float t = v[e] + (e < cnt ? a.bias[d + e] : 0.f);",
        "const float t = __bfloat162float(__float2bfloat16(v[e])) + "
        "(e < cnt ? a.bias[d + e] : 0.f);"),
    # B5 (the mma path, the odd C = 12 case): the input pool reads one
    # column to the right
    "b5_pool_column": (FLAT, "2 * wc + (q & 1) + 1) * LDA",
                       "2 * wc + (q & 1) + 2) * LDA"),
    # B6 (the mma path, the odd C = 12 case): the pool's cotangent left out
    # of the side dz
    "b6_pool_cotangent": (FLAT, "v[e] += f32(dp.v[e]);",
                          "v[e] += 0.f * f32(dp.v[e]);"),
    # B2, B3 (the Hopper path): every tap's input box starts one column to
    # the right (a tap's W coordinate kw for kw - 1)
    "hopper_tap_w_offset": (FLAT, "c0, tl.w0 - 1, tl.h0 + kh - 1, tl.n);",
                            "c0, tl.w0, tl.h0 + kh - 1, tl.n);"),
    # B2, B3 (the Hopper path): the last 64-channel chunk is never loaded or
    # multiplied
    "hopper_last_chunk": (FLAT, "return 3 * s.chunks;",
                          "return 3 * (s.chunks - 1);"),
    # B2 (the Hopper path): the bias added after a bf16 rounding of the sum
    "hopper_bias_after_rounding": (
        FLAT, "const float t = v + b;",
        "const float t = __bfloat162float(__float2bfloat16(v)) + b;"),
    # B3's dz (the Hopper path): the producer's ReLU backward left out
    "hopper_dz_mask": (FLAT, "return __bfloat162float(z) > 0.f ? v : 0.f;",
                       "return v;"),
    # B2's pool (the Hopper path): a window takes the pixel two columns over
    # for its right-hand one
    "hopper_pool_column": (
        FLAT, "return fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 4));",
        "return fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 8));"),
    # B5 (the side Hopper path): the input pool reads the staged box one
    # pixel to the left, so a segment's first window takes the halo pixel
    "side_pool_halo": (FLAT, "const int row = (2 * pr + (e >> 1) + 1) * kFwdBox + 2 * pc + (e & 1) + 1;",
                       "const int row = (2 * pr + (e >> 1) + 1) * kFwdBox + 2 * pc + (e & 1);"),
    # B6's dz (the side Hopper path): the blocks' own weight pack transposes
    # the weight but does not flip its taps
    "side_dz_weight_flip": (FLAT, "const int tap = 8 - t;",
                            "const int tap = t;"),
    # B6's dz (the side Hopper path): a tie in a window's top row routes the
    # cotangent to its right pixel as well as its left one
    "side_route_tie_order": (FLAT, "const unsigned top_first = left ? 0u : other & 3u;",
                             "const unsigned top_first = 0u;"),
    # B6's dz (the side Hopper path): the producer's ReLU backward left out
    # of the top rows
    "side_dz_mask": (FLAT, "float t0 = masked(acc[i][4 * j + 2 * half], zt.x);",
                     "float t0 = acc[i][4 * j + 2 * half];"),
    # B6's dz (the side Hopper path): every tap reads the 16-channel g box
    # one pixel to the right
    "side_dz_tap_column": (
        FLAT, "wgmma_bf16<TN, 0, 0>(acc[i], smem_desc(gs + row * kGRowBytes, 256, 3), b);",
        "wgmma_bf16<TN, 0, 0>(acc[i], smem_desc(gs + (row + 1) * kGRowBytes, 256, 3), b);"),
    # B3 and B6 (the input gradients' weight operand): the pack kernel
    # transposes the weight but does not flip its taps
    "pack_flip": (FLAT, "if (inside) v = layout == 0 ? src[tap] : src[8 - tap];",
                  "if (inside) v = layout == 0 ? src[tap] : src[tap];"),
    # B4 (B3's second launch): the bias gradient skips each block's first
    # K-step (the Hopper path)
    "db_skips_a_step": (
        WGRAD,
        "if (db_tile) colsum += column_sum<TD, KW>(smem + stage * K::kStage, tid);",
        "if (db_tile && u != u0) colsum += column_sum<TD, KW>(smem + stage * K::kStage, tid);"),
    # B17, B4, B6: the x box of every tap starts one column to the right
    # (a tap's W coordinate kw for kw - 1)
    "tap_w_offset": (WGRAD, "c0, seq, w0 - 1, h + kh - 1, n);",
                     "c0, seq, w0, h + kh - 1, n);"),
    # B17, B4, B6: the second pass never adds a tile's last split-K piece
    "last_piece_unsummed": (WGRAD, "for (long long b = b_lo; b <= b_hi; ++b) {",
                            "for (long long b = b_lo; b < b_hi; ++b) {"),
    # B8/B10: a window's cotangent goes to its last tied tap, not the first
    "pool_tie_order": (POOL, "for (int t = 0; t < 4; ++t) {",
                       "for (int t = 3; t >= 0; --t) {"),
    # B7/B9: the ragged last column's windows are never written
    "pool_ragged_column": (POOL, "store<S, VEC>(y + win.out, m);",
                           "if (win.right) store<S, VEC>(y + win.out, m);"),
    # B16 (the mma path, D off a multiple of 8): the last pixel chunk (row
    # segment) of the image is never summed
    "stem_last_chunk": (STEM, "seg_lo + s.per_block < s.segs ? seg_lo + s.per_block : s.segs;",
                        "seg_lo + s.per_block < s.segs ? seg_lo + s.per_block : s.segs - 1;"),
    # B16 (the mma path): a tap's row and column offsets swapped in the
    # stacked operand
    "stem_tap_offset": (STEM, "v = xs[((t / 3) * kStrip + j + t % 3) * kMaxC + c];",
                        "v = xs[((t % 3) * kStrip + j + t / 3) * kMaxC + c];"),
    # the stem's Hopper kernels (stem.cuh): the left halo column of a landed
    # image row keeps the previous row's bytes
    "stem_halo_column": (STEM_H, "reinterpret_cast<uint16_t*>(slot + lead)[tid - s.C] = 0;",
                         "(void)0;"),
    # B16 (the Hopper path): the rolling strip is advanced one row late, its
    # copy reloading the next row instead of the one after it
    "stem_strip_late": (
        STEM, "strip_load(strip_slot(strip, s, r + 2, kSlots), x, s, r + 2, tid, 128);",
        "strip_load(strip_slot(strip, s, r + 1, kSlots), x, s, r + 1, tid, 128);"),
    # the stem's forward (stem.cu): the same, its two new rows one row late
    "stem_fwd_strip_late": (
        STEM_FWD, "for (long long rr = r0 + kWGs + 1; rr <= r0 + 2 * kWGs; ++rr)",
        "for (long long rr = r0 + kWGs; rr < r0 + 2 * kWGs; ++rr)"),
    # B16 (the Hopper path): the ones column (db) moved one value right
    "stem_ones_column": (STEM_H, "v[9 * C] = 0x3F80;", "v[9 * C + 1] = 0x3F80;"),
    # B16 (both paths): the second pass drops the last run's partial
    "stem_reduce_last_partial": (
        STEM, "for (long long k = warp; k < splits; k += kReduceWarps) {",
        "for (long long k = warp; k < splits - 1; k += kReduceWarps) {"),
    # the stem's forward: the output map's rows as long as the segments, so
    # the TMA store writes the ragged last segment's pixels past W into the
    # next row
    "stem_store_tail_past_w": (
        STEM_FWD, "encode_rows_map(&ymap, y, s.rows, s.W, s.W, D, kStemSeg);",
        "encode_rows_map(&ymap, y, s.rows, s.W, s.segs * kStemSeg, D, kStemSeg);"),
    # the stem's forward: the bias added after a bf16 rounding of the sum
    "stem_bias_after_rounding": (
        STEM_FWD, "const float t = v + b;",
        "const float t = __bfloat162float(__float2bfloat16(v)) + b;"),
    # B1: each scale's second column tap dropped
    "tail_second_column_tap": (TAIL, "acc += t0 * cw[s].x + t1 * cw[s].y;",
                               "acc += t0 * cw[s].x;"),
    # B1: the vertical blend reads source row r.x for both row taps
    "tail_blend_row_x_twice": (TAIL, "t.w.y * smem[t.i.y + c]",
                               "t.w.y * smem[t.i.x + c]"),
    # B1: the last row of each block's run is never written
    "tail_run_last_row": (
        TAIL, "s_run[1] = p.rows * (blockIdx.x + 1) / gridDim.x;",
        "s_run[1] = p.rows * (blockIdx.x + 1) / gridDim.x - 1;"),
    # B13/B11: the last tile of each sample is left out of the fold
    "stats_fold_last_tile": (CBBCE, "for (int j = lane; j < chunks; j += 32) {",
                             "for (int j = lane; j < chunks - 1; j += 32) {"),
    # B13/B11: the scalar head of an unaligned row is never summed
    "stats_unaligned_head": (CBBCE, "if (has_head) add_one(hx, hz, cnt, sp, sn);",
                             "if (false) add_one(hx, hz, cnt, sp, sn);"),
    # B13/B11: no grid barrier between the tiles' partials and their fold
    "stats_grid_sync": (CBBCE, "cg::this_grid().sync();", "(void)0;"),
    # I1: the epilogue's multiply and add contracted into one FMA
    "int8_epilogue_fma": (
        INT8, "__fadd_rn(__fmul_rn(__int2float_rn(acc[i][j][2 * half + e]), sc[e]), bi[e])",
        "__fmaf_rn(__int2float_rn(acc[i][j][2 * half + e]), sc[e], bi[e])"),
    # I1: the K tail not zeroed: under 16-byte loads a piece's x side past
    # Cin reads the next pixel's channels (Cin 16 and 48)
    "int8_k_tail": (INT8, "      if (16 * u < limit) {", "      if (true) {"),
    # I1: the last, partial tile of output channels dropped
    "int8_last_cout_tile": (INT8, "a.n_tiles = (Cout + kBN - 1) / kBN;",
                            "a.n_tiles = Cout / kBN;"),
    # I1: the bottom halo tap (row H, off the image) read from the next
    # image's first row instead of zero
    "int8_halo_row": (INT8, "hh >= 0 && hh < a.H", "hh >= 0 && hh <= a.H"),
    # I1's Hopper path: the quantization rounds toward zero, not to even
    "int8q_round_trunc": (
        INT8, "sum[e] = __float_as_uint(__fadd_rn(v, kQRound));",
        "sum[e] = __float_as_uint(__fadd_rz(v, kQRound));"),
    # I1's Hopper path: the clamp lets +127.5 and above through as 128
    "int8q_clamp": (INT8, "    v = fminf(v, 127.f);", "    v = fminf(v, 128.f);"),
    # I1's Hopper path: the taps of kernel column kw read the mirrored
    # column's pixels
    "int8q_tap_shift": (
        INT8, "const int row = (kQRowsWG * wg + i + kh) * kQBoxW + kw;",
        "const int row = (kQRowsWG * wg + i + kh) * kQBoxW + 2 - kw;"),
    # I1's Hopper path: the epilogue's multiply and add contracted
    "int8q_epilogue_fma": (
        INT8, "float v0 = __fadd_rn(__fmul_rn(__int2float_rn(v[0]), sc[r].x), bi[r].x);",
        "float v0 = __fmaf_rn(__int2float_rn(v[0]), sc[r].x, bi[r].x);"),
    # I1's Hopper path: the max counts -0.0 by its bits (above every value)
    "int8q_max_negative_zero": (INT8, "return u == 0x80000000u ? 0u : u;", "return u;"),
    # I1's Hopper path: the block's max leaves out its second warpgroup
    "int8q_max_skips_warps": (
        INT8, "for (int w = 0; w < kQConsumers / 32; ++w) m = max(m, red[w]);",
        "for (int w = 0; w < kQConsumers / 64; ++w) m = max(m, red[w]);"),
    # I1's Hopper path: the last output-channel tile dropped
    "int8q_last_cout_tile": (INT8, "s.n_tiles = Cout / tn;", "s.n_tiles = (Cout - 1) / tn;"),
    # the rounds: the last round's pads kept in the gathered result (the
    # gloo ranks of parallel/dryrun.py, 3 sequences over 2 ranks)
    "par_rounds_pads_kept": (BATCHED, "        states, losses = states[:s], losses[:s]\n",
                             "\n"),
    # data parallel: the gradients (and metrics) summed over the ranks, not
    # averaged (the gloo ranks against one rank)
    "par_dp_grad_summed": (MESH, "    flat.div_(mesh.size())\n", "\n"),
    # the rounds: every sequence draws from the generator of cfg.seed (the
    # card's rounds against run_online seeded cfg.seed + i)
    "par_draws_one_seed": (
        BATCHED, "                          torch.Generator().manual_seed(cfg.seed + i))",
        "                          torch.Generator().manual_seed(cfg.seed))"),
    # the packed schedule: B17's sequence launch reads sequence 0's x for
    # every sequence (the card tests' and phase 9c's lone launches)
    "pk_seq_reads_seq0": (WGRAD, "c0, seq, w0 - 1, h + kh - 1, n);",
                          "c0, 0, w0 - 1, h + kh - 1, n);"),
    # B16's sequence launch: the gather fills sequence s's strip with the
    # channels of sequence s + 1 (the card tests' lone launches)
    "pk_seq_gather_next": (STEM, "const uint16_t* src = x + r * s.W * pixel + seq * C;",
                           "const uint16_t* src = x + r * s.W * pixel + (seq + 1) % S * C;"),
    # the sequence-major decode of both sequence launches hands sequences 0
    # and 1 (2 and 3) the same index: one is run twice, the other never
    # (the card tests' lone launches; S = 1 decodes as before)
    "pk_seq_decode_same": (HOPPER_H,
                           "return {static_cast<int>(i % S), static_cast<int>(i / S)};",
                           "return {static_cast<int>(i % S) & ~1, static_cast<int>(i / S)};"),
    # the packed loss meaned over all S * N rows, not per sequence: each
    # sequence's gradient 1/S of its own (phase 9b's gloo ranks, whose
    # blocks of 2 and 3 sequences then scale it apart; phase 9c's packed
    # against the rounds)
    "pk_loss_mean_all": (PACKED, "            loss.sum().backward()\n            return loss.detach()",
                         "            per.mean().backward()\n            return loss.detach()"),
    # the packed schedule on a mesh: the last block's pads kept (the gloo
    # ranks of phase 9b's dry run against one rank)
    "pk_pads_kept": (BATCHED, "    states, rows = states[:s], rows[:s]  # the last block's pads dropped",
                     "    pass  # the last block's pads dropped"),
    # --vis_net: make_dot's walk leaves out one parameter leaf, the fuse
    # bias (phase 8b's net.dot names every leaf)
    "vis_drop_leaf": (
        VIS, "        queue.extend(nxt for nxt, _ in fn_node.next_functions\n"
             "                     if nxt is not None)",
        "        queue.extend(nxt for nxt, _ in fn_node.next_functions\n"
             "                     if nxt is not None and names.get(id(getattr(\n"
             "                         nxt, 'variable', None))) != 'fuse.bias')"),
}


def main(prefixes=None) -> int:
    prefixes = sys.argv[1:] if prefixes is None else prefixes
    results = {}
    for name, (path, text, repl) in MUTANTS.items():
        if prefixes and not name.startswith(tuple(prefixes)):
            continue
        dst = os.path.join(ROOT, "build", "mutants", name)
        shutil.rmtree(dst, ignore_errors=True)
        shutil.copytree(ROOT, dst, ignore=shutil.ignore_patterns(
            "build", ".git", "__pycache__"))
        src = os.path.join(dst, path)
        with open(src) as f:
            code = f.read()
        if code.count(text) != 1:
            raise SystemExit(f"{name}: the text to mutate occurs "
                             f"{code.count(text)} times in {path}")
        with open(src, "w") as f:
            f.write(code.replace(text, repl))
        proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=dst,
                              capture_output=True, text=True, timeout=1200)
        lines = (proc.stdout + proc.stderr).strip().splitlines()
        why = next((ln for ln in reversed(lines) if "chip_smoke:" in ln),
                   lines[-1] if lines else "")
        results[name] = {"exit": proc.returncode, "failed": why[-300:]}
        print(f"[mutant] {name}: exit {proc.returncode}; {why[-300:]}",
              flush=True)
        shutil.rmtree(dst, ignore_errors=True)
    survivors = [n for n, r in results.items() if r["exit"] == 0]
    print(json.dumps({"mutants": len(results), "survivors": survivors}))
    return 1 if survivors else 0


if __name__ == "__main__":
    sys.exit(main())
