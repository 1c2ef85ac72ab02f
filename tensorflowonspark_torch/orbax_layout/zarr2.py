"""One zarr v2 array from its ``.zarray`` metadata and its chunk values,
as orbax writes them through tensorstore: ``<name>/.zarray`` and one
value per chunk, ``<name>/<i>.<j>...`` (``<name>/0`` for a 0-d array).

Read here: ``compressor`` zstd or null, ``filters`` null, ``order`` C,
``dimension_separator`` ``.`` or ``/``; dtypes numpy names
(``<f4``, ``<i8``, ``|b1``, ...) and the names ``bfloat16`` and
``float8_*`` that numpy lacks.  Those come back as CPU tensors of the torch
dtype (``dtypes.EXTENDED_DTYPES``: the raw bits viewed, as the npz
bundle path reads them), every other array as numpy.  A chunk of the grid's
edge is stored at full chunk size and sliced; a missing chunk takes
``fill_value`` (``null``: zeros).  Anything else raises ``ValueError``
naming the field.
"""

from __future__ import annotations

import itertools
import json
import math
from typing import Callable

import numpy as np
import torch

from tensorflowonspark_torch.orbax_layout import zstd
from tensorflowonspark_torch.dtypes import EXTENDED_DTYPES

_FLOAT_FILLS = {"NaN": np.nan, "Infinity": np.inf, "-Infinity": -np.inf}


def _dtype(name: str, where: str) -> tuple[np.dtype, torch.dtype | None]:
    """(numpy storage dtype, torch dtype to view it as, or None)."""
    if name in EXTENDED_DTYPES:
        storage, dtype = EXTENDED_DTYPES[name]
        return np.dtype(storage), dtype
    try:
        dt = np.dtype(name)
    except TypeError:
        raise ValueError(f"zarr: {where} has dtype {name!r}, which this reader cannot "
                         f"read (numpy names and {sorted(EXTENDED_DTYPES)})") from None
    if dt.kind not in "biuf" or dt.fields is not None:
        raise ValueError(f"zarr: {where} has dtype {name!r}; this reader reads bool, "
                         "integer and float arrays")
    return dt, None


def _fill(value, dtype: np.dtype, where: str):
    if value is None:
        return 0
    if isinstance(value, str):
        if value not in _FLOAT_FILLS or dtype.kind != "f":
            raise ValueError(f"zarr: {where} has fill_value {value!r}")
        return _FLOAT_FILLS[value]
    return value


def read_array(get: Callable[[str], bytes | None], name: str):
    """The array ``name``; ``get(key)`` returns a stored value or None."""
    where = f"{name}/.zarray"
    raw = get(where)
    if raw is None:
        raise ValueError(f"zarr: no {where}")
    meta = json.loads(raw)
    if meta.get("zarr_format") != 2:
        raise ValueError(f"zarr: {where} has zarr_format {meta.get('zarr_format')!r}, not 2")
    if meta.get("order", "C") != "C":
        raise ValueError(f"zarr: {where} has order {meta['order']!r}; this reader reads C")
    if meta.get("filters"):
        raise ValueError(f"zarr: {where} has filters {meta['filters']!r}; this reader "
                         "reads none")
    compressor = meta.get("compressor")
    if compressor is not None and compressor.get("id") != "zstd":
        raise ValueError(f"zarr: {where} has compressor {compressor!r}; this reader "
                         "reads zstd and null")
    sep = meta.get("dimension_separator", ".")
    if sep not in (".", "/"):
        raise ValueError(f"zarr: {where} has dimension_separator {sep!r}")
    storage, view = _dtype(meta["dtype"], where)
    shape = tuple(int(n) for n in meta["shape"])
    chunks = tuple(int(n) for n in meta["chunks"])
    if len(chunks) != len(shape) or any(c <= 0 for c in chunks):
        raise ValueError(f"zarr: {where} has chunks {list(chunks)} for shape {list(shape)}")
    fill = _fill(meta.get("fill_value"), storage, where)
    if view is not None and fill != 0:
        raise ValueError(f"zarr: {where} has fill_value {fill!r} for {meta['dtype']}")

    out = np.empty(shape, storage)
    chunk_bytes = math.prod(chunks) * storage.itemsize
    grid = [range(math.ceil(n / c)) for n, c in zip(shape, chunks)]
    for index in itertools.product(*grid):
        key = f"{name}/{sep.join(map(str, index)) if index else '0'}"
        region = tuple(slice(i * c, min((i + 1) * c, n))
                       for i, c, n in zip(index, chunks, shape))
        value = get(key)
        if value is None:
            out[region] = fill
            continue
        if compressor is not None:
            buf = np.empty(chunk_bytes, np.uint8)
            try:
                got = zstd.decompress_into(value, buf)
            except ValueError as e:
                raise ValueError(f"zarr: chunk {key}: {e}") from None
        else:
            buf, got = np.frombuffer(value, np.uint8), len(value)
        if got != chunk_bytes:
            raise ValueError(f"zarr: chunk {key} holds {got} bytes, a {list(chunks)} "
                             f"{meta['dtype']} chunk is {chunk_bytes}")
        block = buf.view(storage).reshape(chunks)
        out[region] = block[tuple(slice(0, s.stop - s.start) for s in region)]
    if not out.dtype.isnative:
        out = out.astype(out.dtype.newbyteorder("="))
    if view is not None:
        return torch.from_numpy(out).view(view)
    return out
