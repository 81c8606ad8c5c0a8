from . import camera, se3, so3, triangulation  # noqa: F401
from .se3 import SE3  # noqa: F401
from .camera import StereoCamera  # noqa: F401
