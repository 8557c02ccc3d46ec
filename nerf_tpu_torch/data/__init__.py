"""Data layer: device-resident ray banks and scene datasets."""
from nerf_tpu_torch.data.rays import RayBank
from nerf_tpu_torch.data.scenes import SceneData, synthesize_scene, spherical_poses
