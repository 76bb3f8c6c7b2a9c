from neupan_torch.models.obs_point_net import ObsPointNet, load_checkpoint  # noqa: F401
