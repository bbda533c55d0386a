from osvos_torch.models.vgg_osvos import OSVOS, stage_conv_names  # noqa: F401
from osvos_torch.models.surgery import (  # noqa: F401
    init_osvos_params,
    load_torch_state_dict,
    params_from_jax,
    params_to_jax,
)
