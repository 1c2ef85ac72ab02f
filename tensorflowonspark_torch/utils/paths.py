"""Filesystem path plumbing.

Parity with ``TFNode.hdfs_path(ctx, path)`` (``tensorflowonspark/TFNode.py:~30-70``):
resolve user-relative paths against a default filesystem so checkpoints land
on HopsFS/HDFS in production and on local disk in tests.  The reference
prefixes ``hdfs://namenode/...``; here remote schemes can be *mapped* to a
local mount root (tests register ``hdfs://`` → tmpdir), because checkpoint
libraries (orbax) speak POSIX while production TPU-VM images mount HopsFS/GCS
via FUSE.
"""

from __future__ import annotations

import os
from urllib.parse import urlparse

# scheme -> local root that backs it (e.g. a FUSE mountpoint).
_FS_ROOTS: dict[str, str] = {}

# Env carrier so registrations survive into spawned node processes: the
# launchers pass os.environ through to children (the same way Spark shipped
# the Hadoop conf to executors), so a driver-side register_fs_root is
# visible inside every node's resolve_uri without extra plumbing.
_ENV_KEY = "TOS_FS_ROOTS"


def register_fs_root(scheme: str, local_root: str, export: bool = True) -> None:
    """Map a filesystem scheme (``hdfs``, ``hopsfs``, ``gs``) to a local root.

    ``export=True`` (default) also records the mapping in ``os.environ`` so
    node processes launched afterwards inherit it.
    """
    _load_env_roots()  # don't drop inherited mappings when re-exporting
    _FS_ROOTS[scheme.rstrip(":/")] = local_root
    if export:
        os.environ[_ENV_KEY] = os.pathsep.join(
            f"{s}={r}" for s, r in sorted(_FS_ROOTS.items()))


def _load_env_roots() -> None:
    from tensorflowonspark_torch.utils.envtune import env_str

    for pair in env_str("TOS_FS_ROOTS", "").split(os.pathsep):
        if "=" in pair:
            scheme, root = pair.split("=", 1)
            _FS_ROOTS.setdefault(scheme, root)


def resolve_uri(path: str) -> str:
    """Translate a possibly-remote URI into a local filesystem path.

    ``hdfs://nn/a/b`` with root ``/mnt/hopsfs`` → ``/mnt/hopsfs/a/b``.
    Unregistered schemes raise so misconfiguration fails fast.
    """
    parsed = urlparse(path)
    if parsed.scheme in ("", "file"):
        return parsed.path if parsed.scheme == "file" else path
    if parsed.scheme not in _FS_ROOTS:
        _load_env_roots()
    root = _FS_ROOTS.get(parsed.scheme)
    if root is None:
        raise ValueError(
            f"no local root registered for scheme {parsed.scheme!r}; "
            f"call register_fs_root({parsed.scheme!r}, <mountpoint>)"
        )
    return os.path.join(root, parsed.path.lstrip("/"))


def absolute_path(path: str, default_fs: str = "", working_dir: str | None = None) -> str:
    """Resolve ``path`` the way ``TFNode.hdfs_path`` does.

    - absolute local path or explicit scheme → unchanged;
    - relative path with a ``default_fs`` (e.g. ``hdfs://nn/user/x``) →
      joined under the default fs;
    - otherwise → joined under ``working_dir`` (cwd by default).
    """
    if urlparse(path).scheme or os.path.isabs(path):
        return path
    if default_fs:
        return default_fs.rstrip("/") + "/" + path
    return os.path.join(working_dir or os.getcwd(), path)
