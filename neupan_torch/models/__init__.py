from neupan_torch.models.obs_point_net import (  # noqa: F401
    ObsPointNet,
    load_checkpoint,
    save_checkpoint,
    to_jax_params,
)
