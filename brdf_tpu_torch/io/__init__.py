"""Scene inputs: meshes, calibrations, image stacks, the light rig (host numpy)."""

from brdf_tpu_torch.io.obj import load_obj  # noqa: F401
from brdf_tpu_torch.io.cal import load_cal, TsaiCalibration  # noqa: F401
from brdf_tpu_torch.io.images import load_image_stack, load_scene_images  # noqa: F401
from brdf_tpu_torch.io.rig import led_rig_positions, ring_rig  # noqa: F401
