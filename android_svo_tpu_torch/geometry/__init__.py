from android_svo_tpu_torch.geometry.se3 import SE3, SO3
from android_svo_tpu_torch.geometry.camera import PinholeCamera
from android_svo_tpu_torch.geometry import robust, triangulation

__all__ = ["SE3", "SO3", "PinholeCamera", "robust", "triangulation"]
