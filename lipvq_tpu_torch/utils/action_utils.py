"""Action dict <-> vector + rotation conversions (copy of
``lipvq_tpu/utils/action_utils.py``).

Counterpart of reference utils/action_utils.py (dict<->vector, :11-60) and
the rotation helpers in utils/torch_utils.py:237-280 used by the rollout
policy to convert rot_6d action components back to axis-angle
(reference algo.py:692-706).
"""

from __future__ import annotations

from collections import OrderedDict

import numpy as np
from scipy.spatial.transform import Rotation


def action_dict_to_vector(action_dict: dict, action_keys=None) -> np.ndarray:
    if action_keys is None:
        action_keys = list(action_dict.keys())
    return np.concatenate(
        [np.asarray(action_dict[k], np.float32) for k in action_keys], axis=-1
    )


def vector_to_action_dict(vector: np.ndarray, action_shapes: dict,
                          action_keys=None) -> dict:
    if action_keys is None:
        action_keys = list(action_shapes.keys())
    out = OrderedDict()
    i = 0
    for k in action_keys:
        n = int(np.prod(action_shapes[k]))
        out[k] = vector[..., i : i + n]
        i += n
    assert i == vector.shape[-1], (i, vector.shape)
    return out


def rotation_6d_to_matrix(d6: np.ndarray) -> np.ndarray:
    """6D rotation representation -> rotation matrix (Zhou et al. 2019,
    pytorch3d convention: Gram-Schmidt on the first two rows)."""
    a1, a2 = d6[..., :3], d6[..., 3:]
    b1 = a1 / np.linalg.norm(a1, axis=-1, keepdims=True)
    dot = np.sum(b1 * a2, axis=-1, keepdims=True)
    b2 = a2 - dot * b1
    b2 = b2 / np.linalg.norm(b2, axis=-1, keepdims=True)
    b3 = np.cross(b1, b2)
    return np.stack([b1, b2, b3], axis=-2)


def matrix_to_rotation_6d(mat: np.ndarray) -> np.ndarray:
    return mat[..., :2, :].reshape(mat.shape[:-2] + (6,))


def rot_6d_to_axis_angle(d6: np.ndarray) -> np.ndarray:
    """[..., 6] -> [..., 3] axis-angle (reference torch_utils rot path)."""
    mat = rotation_6d_to_matrix(d6)
    flat = mat.reshape(-1, 3, 3)
    rv = Rotation.from_matrix(flat).as_rotvec()
    return rv.reshape(d6.shape[:-1] + (3,)).astype(np.float32)


def axis_angle_to_rot_6d(aa: np.ndarray) -> np.ndarray:
    flat = np.asarray(aa, np.float64).reshape(-1, 3)
    mat = Rotation.from_rotvec(flat).as_matrix()
    d6 = matrix_to_rotation_6d(mat)
    return d6.reshape(aa.shape[:-1] + (6,)).astype(np.float32)


def rot_6d_to_euler_angles(d6: np.ndarray, convention: str = "XYZ") -> np.ndarray:
    mat = rotation_6d_to_matrix(d6).reshape(-1, 3, 3)
    e = Rotation.from_matrix(mat).as_euler(convention.lower())
    return e.reshape(d6.shape[:-1] + (3,)).astype(np.float32)
