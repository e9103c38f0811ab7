"""Device meshes over torch.distributed, the sharded normal equations and the
joint multi-scene bundle adjustment."""
