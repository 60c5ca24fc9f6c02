"""Run an unedited script written for the JAX package or for the
reference's `flexflow` namespace on the port.

    python -m flexflow_tpu_torch.run [--device cuda|cuda:N|cpu] script.py [args...]

The repo's example scripts import `flexflow` (the reference's Python
package: `from flexflow.core import *`, `flexflow.keras.models`, ...) or
the JAX package by name. `install` puts an import finder first on
sys.meta_path that resolves

  * `flexflow` and its submodules to flexflow_tpu_torch.flexflow and
    its submodules (the drop-in namespace), and
  * the JAX package's name and its submodules to flexflow_tpu_torch and
    the same submodules,

each alias being the port module itself (one object under two names).
The port module keeps its own `__name__`, `__spec__` and `__file__`, so
`python -m` launches of port modules (the process-group ranks of
runtime/mesh_run.py) see the port's names. `install` refuses to run
once jax, `flexflow` or the JAX package is loaded: the script would mix
the two packages.

`--device` (default "cuda") sets the process's default device
(config.set_default_device), which a config reads only where the caller
names no device: a script or config that names one keeps it, and "cuda"
on a machine without a card raises at the first config. `run_path` runs
the script as `__main__` with its own sys.argv and its directory first
on sys.path, as `python script.py` would, in the caller's working
directory (where scripts write their .ff/.onnx exports). The runner adds
no behavior of its own.
"""
from __future__ import annotations

import argparse
import importlib
import importlib.abc
import importlib.util
import os
import runpy
import sys
from typing import Optional, Sequence

from . import config

PORT = "flexflow_tpu_torch"
# alias root -> the port module it names
_ROOTS = {"flexflow": PORT + ".flexflow", "flexflow_tpu": PORT}
# modules whose presence makes install refuse
_REFUSED = ("jax",) + tuple(_ROOTS)


def _target(fullname: str) -> Optional[str]:
    """The port module an alias names, or None for any other name."""
    root, dot, rest = fullname.partition(".")
    if root not in _ROOTS:
        return None
    return _ROOTS[root] + dot + rest


class _AliasLoader(importlib.abc.Loader):
    """Hands the import system the port module itself. The import system
    sets `module.__spec__` to the alias's spec after create_module
    (importlib._bootstrap._init_module_attrs), so exec_module puts the
    port's spec back."""

    def __init__(self, module):
        self.module = module
        self.spec = module.__spec__

    def create_module(self, spec):
        return self.module

    def exec_module(self, module):
        module.__spec__ = self.spec


class AliasFinder(importlib.abc.MetaPathFinder):
    """Resolves `flexflow[.X]` and the JAX package's `[.X]` names to the
    port's modules."""

    def find_spec(self, fullname, path=None, target=None):
        name = _target(fullname)
        if name is None:
            return None
        module = importlib.import_module(name)
        return importlib.util.spec_from_loader(
            fullname, _AliasLoader(module),
            is_package=hasattr(module, "__path__"))


def _finder() -> Optional[AliasFinder]:
    for f in sys.meta_path:
        if isinstance(f, AliasFinder):
            return f
    return None


def install(device: str = "cuda") -> None:
    """Alias `flexflow` and the JAX package's name to the port and make
    `device` the default device. Raises RuntimeError when jax,
    `flexflow` or the JAX package is already imported; installing again
    only changes the device."""
    if _finder() is None:
        loaded = sorted(m for m in _REFUSED if m in sys.modules)
        if loaded:
            raise RuntimeError(
                f"cannot alias the port: {', '.join(loaded)} already "
                "imported in this process (the script would run on both "
                "packages); start a fresh interpreter")
        sys.meta_path.insert(0, AliasFinder())
    config.set_default_device(device)


def run_path(path: str, argv: Sequence[str] = ()) -> None:
    """Run the script at `path` as `__main__` with sys.argv [path, *argv]
    and its directory first on sys.path (installing the aliases first,
    at the default device, if they are not). sys.argv and sys.path are
    restored afterwards, and modules imported from the script's
    directory are dropped, so a later script's same-named helpers load
    from its own directory."""
    if _finder() is None:
        install(config.default_device())
    path = os.path.abspath(path)
    script_dir = os.path.dirname(path)
    old_argv, old_path = sys.argv, list(sys.path)
    before = set(sys.modules)
    sys.argv = [path] + list(argv)
    sys.path.insert(0, script_dir)
    try:
        runpy.run_path(path, run_name="__main__")
    finally:
        sys.argv = old_argv
        sys.path[:] = old_path
        for name in set(sys.modules) - before:
            f = getattr(sys.modules[name], "__file__", None)
            if f and os.path.dirname(os.path.abspath(f)) == script_dir:
                del sys.modules[name]


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m flexflow_tpu_torch.run",
        description="Run a script written for the flexflow namespace or "
                    "the JAX package on the port.")
    ap.add_argument("--device", default="cuda",
                    help="the default device: cuda (the default), cuda:N "
                         "or cpu")
    ap.add_argument("script")
    ap.add_argument("args", nargs=argparse.REMAINDER,
                    help="the script's own arguments")
    a = ap.parse_args(argv)
    install(a.device)
    run_path(a.script, a.args)
    return 0


if __name__ == "__main__":
    # run through the module under its own name, so that a script which
    # imports this module finds the finder and the device installed here
    from flexflow_tpu_torch import run as _run

    sys.exit(_run.main())
