"""Camera model and camera paths, shared with the JAX package.

``vulkan_pathtracer_tpu/models/camera.py`` and ``app/camera_path.py``
are NumPy only (no JAX): the camera's basis vectors are host f32
arrays that the pipeline uploads per frame (``render/pipeline.
camera_tensors``), so the port imports them instead of copying them.
"""

from vulkan_pathtracer_tpu.app.camera_path import CameraPath, orbit_path
from vulkan_pathtracer_tpu.models.camera import Camera

__all__ = ["Camera", "CameraPath", "orbit_path"]
