"""Volume export of the serving CLI (JAX ``utils/visualize.py:139-146``;
reference src/util.py:257-309).  ``nibabel`` is imported only to write a
file; without it ``save_volume_nifti`` raises ``ImportError``."""

from __future__ import annotations

import numpy as np


def require_nibabel():
    try:
        import nibabel
    except ImportError as e:
        raise ImportError("nibabel required for NIfTI export") from e
    return nibabel


def save_volume_nifti(save_path: str, data: np.ndarray) -> None:
    """data: [D, H, W] (slice-major) -> NIfTI [H, W, D], identity affine."""
    nib = require_nibabel()
    nib.save(nib.Nifti1Image(np.transpose(data, (1, 2, 0)), np.eye(4)),
             save_path)
