"""Model-artifact fetching: the port of ``seldon_core_tpu/storage``.

Local paths and ``file://`` URIs resolve to a directory on disk (copied
under ``out_dir`` when one is given). Object stores and HTTP need their
client packages, which the card's machine does not carry: those schemes
raise ``StorageError`` naming the client they would need.
"""

from __future__ import annotations

import os
import shutil
from typing import Optional
from urllib.parse import urlparse


class StorageError(RuntimeError):
    pass


_CLIENTS = {
    "gs": "google-cloud-storage",
    "s3": "boto3",
    "http": "requests (or azure-storage-blob for *.blob.core.windows.net)",
    "https": "requests (or azure-storage-blob for *.blob.core.windows.net)",
}


def download(uri: str, out_dir: Optional[str] = None) -> str:
    """Fetch a model artifact directory/file to local disk, returning the path."""
    parsed = urlparse(uri)
    scheme = parsed.scheme
    if scheme in ("", "file"):
        return _local(parsed.path if scheme == "file" else uri, out_dir)
    if scheme in _CLIENTS:
        raise StorageError(f"{scheme}:// model URIs need {_CLIENTS[scheme]}, which the port "
                           f"does not use: copy the artifact to a local path or file:// URI")
    raise StorageError(f"Unsupported model URI scheme {scheme!r} in {uri!r}")


def _local(path: str, out_dir: Optional[str]) -> str:
    path = os.path.abspath(path)
    if not os.path.exists(path):
        raise StorageError(f"Local model path does not exist: {path}")
    if out_dir is None:
        return path
    os.makedirs(out_dir, exist_ok=True)
    if os.path.isdir(path):
        dst = os.path.join(out_dir, os.path.basename(path.rstrip("/")))
        if not os.path.exists(dst):
            shutil.copytree(path, dst)
        return dst
    dst = os.path.join(out_dir, os.path.basename(path))
    shutil.copy2(path, dst)
    return dst


__all__ = ["StorageError", "download"]
