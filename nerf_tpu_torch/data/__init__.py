"""Data layer: device-resident ray banks and scene datasets."""
from nerf_tpu_torch.data.rays import RayBank
from nerf_tpu_torch.data.scenes import SceneData, load_tiny_nerf, synthesize_scene, spherical_poses
