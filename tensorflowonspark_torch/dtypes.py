"""The array types numpy lacks (bfloat16, float8), as the port stores and
reads them: the raw bits in a numpy integer array of the same width, viewed
as the torch dtype on the way in.  Shared by the npz bundle layout
(``checkpoint.py``) and the orbax reader (``orbax_layout/zarr2.py``)."""

from __future__ import annotations

import numpy as np
import torch

# ml_dtypes name -> (numpy storage type, torch dtype)
EXTENDED_DTYPES = {
    "bfloat16": (np.uint16, torch.bfloat16),
    "float8_e4m3fn": (np.uint8, torch.float8_e4m3fn),
    "float8_e5m2": (np.uint8, torch.float8_e5m2),
}
TORCH_TO_EXTENDED = {t: (name, st) for name, (st, t) in EXTENDED_DTYPES.items()}
