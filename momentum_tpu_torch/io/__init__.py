"""The file layer: glTF (.glb), FBX (binary and ASCII), USD (.usda and
.usdc), URDF and BVH characters and motions, marker sequences, the rig's
.model / .locators / legacy JSON side-cars, MPPCA pose priors, blend and
pose shapes, C3D and TRC marker takes, .mmo motions and OBJ meshes. Files
are parsed and written on the host; every loader builds its character,
tables and tensors on `device`, the card unless the caller asks for the
CPU."""

from momentum_tpu_torch.io.character_io import (  # noqa: F401
    character_format,
    load_full_character,
    save_character,
)
from momentum_tpu_torch.io.bvh import load_bvh, save_bvh  # noqa: F401
from momentum_tpu_torch.io.fbx import load_fbx, load_fbx_with_motion  # noqa: F401
from momentum_tpu_torch.io.fbx_writer import (  # noqa: F401
    save_fbx,
    save_fbx_model,
    save_fbx_with_joint_params,
)
from momentum_tpu_torch.io.fbx_builder import FbxBuilder  # noqa: F401
from momentum_tpu_torch.io.gltf_builder import (  # noqa: F401
    GltfBuilder,
    load_all_characters_glb,
)
from momentum_tpu_torch.io.locators import load_locators, save_locators  # noqa: F401
from momentum_tpu_torch.io.urdf import load_urdf  # noqa: F401
from momentum_tpu_torch.io.gltf import (  # noqa: F401
    load_character_glb,
    load_motion_glb,
    save_character_glb,
)
from momentum_tpu_torch.io.gltf import load_motion_glb as load_motion  # noqa: F401
from momentum_tpu_torch.io.markers import (  # noqa: F401
    RawMarkerData,
    load_c3d,
    load_markers,
    load_markers_from_bytes,
    load_trc,
    save_trc,
)
from momentum_tpu_torch.io.model_definition import (  # noqa: F401
    load_model_definition,
    load_momentum_model,
    parse_parameter_limits,
    parse_parameter_sets,
    parse_parameter_transform,
    write_model_definition,
)
from momentum_tpu_torch.io.motion import load_mmo, save_mmo  # noqa: F401
from momentum_tpu_torch.io.pose_prior import load_mppca, save_mppca  # noqa: F401
from momentum_tpu_torch.io.usd import (  # noqa: F401
    load_usd,
    load_usda,
    save_usd,
    save_usda,
)
from momentum_tpu_torch.io.obj import export_motion_objs, save_obj  # noqa: F401
from momentum_tpu_torch.io.legacy_json import load_legacy_json, save_legacy_json  # noqa: F401
