"""The native (C++) host featurizer, ``fastfeat`` (``laff_tpu.native``'s
copy): BoW counting and GRU index encoding of a batch of captions into
numpy buffers, with the Python path's exact results.

``get_fastfeat()`` compiles ``fastfeat.cpp`` with the system C++ compiler
(``$CXX``, else ``g++``) at first use and imports it; it returns None, and
the featurizers keep their Python path, when there is no compiler or the
build fails. The extension goes where the CUDA kernels go (``build/
laff_tpu_torch/`` of a source checkout, else the user's cache directory),
never beside its source, under a name that hashes the source and the
flags. ``CALLS`` counts the batches each function encoded.
"""

from __future__ import annotations

import hashlib
import importlib.util
import os
import subprocess
import sysconfig
import threading
from pathlib import Path
from types import ModuleType
from typing import Dict, Optional

from ..ops.kernels import BUILD_DIR
from ..utils import get_logger

logger = get_logger(__name__)

_SRC = Path(__file__).resolve().with_name("fastfeat.cpp")
_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

CALLS: Dict[str, int] = {"encode_bow": 0, "encode_idx": 0}
_lock = threading.Lock()
_state: Dict[str, object] = {"module": None, "failed": False}


def library_path() -> Path:
    h = hashlib.sha1(_SRC.read_bytes())
    h.update(" ".join(_FLAGS).encode())
    suffix = sysconfig.get_config_var("EXT_SUFFIX") or ".so"
    return BUILD_DIR / f"fastfeat-{h.hexdigest()[:12]}{suffix}"


def _build(so: Path) -> None:
    so.parent.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    cmd = [os.environ.get("CXX", "g++"), *_FLAGS,
           f"-I{sysconfig.get_paths()['include']}", str(_SRC), "-o", str(tmp)]
    subprocess.run(cmd, check=True, capture_output=True, text=True, timeout=300)
    os.replace(tmp, so)


def get_fastfeat() -> Optional[ModuleType]:
    """The compiled extension, built at first use; None when it cannot be
    built or loaded (the caller takes the Python path)."""
    with _lock:
        if _state["module"] is not None or _state["failed"]:
            return _state["module"]
        try:
            so = library_path()  # the source itself is missing from a wheel
            if not so.exists():
                _build(so)
            spec = importlib.util.spec_from_file_location("fastfeat", so)
            module = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(module)
        except (OSError, ImportError, subprocess.SubprocessError) as e:
            detail = getattr(e, "stderr", "") or str(e)
            logger.warning("fastfeat unavailable (%s); the featurizers take the Python path",
                           detail.strip()[:300])
            _state["failed"] = True
            return None
        logger.info("fastfeat native featurizer loaded from %s", so)
        _state["module"] = module
        return module


def count(name: str) -> None:
    with _lock:
        CALLS[name] += 1


def reset_calls() -> None:
    with _lock:
        for name in CALLS:
            CALLS[name] = 0
