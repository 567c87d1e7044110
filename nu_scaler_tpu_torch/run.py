"""Run the app (`nu_scaler`), unmodified, on the port:

    python -m nu_scaler_tpu_torch.run [--device cuda|cpu] <module> [args...]

for example

    python -m nu_scaler_tpu_torch.run --device cpu nu_scaler.transcode in.y4m out.y4m --scale 2

runs ``<module>`` as ``__main__`` with the given arguments and exits with its
code. Before that it puts an import finder first in `sys.meta_path` that
serves the app's imports of the JAX package from the port:

- ``nu_scaler_core`` is the port's `core`;
- ``nu_scaler_tpu.capture.video`` is the port's `capture/video.py`, and
  ``nu_scaler_tpu.runtime.detector`` its `runtime/detector.py`;
- their parents ``nu_scaler_tpu``, ``nu_scaler_tpu.capture`` and
  ``nu_scaler_tpu.runtime`` are empty stand-in packages (the JAX package's
  own ``__init__`` files import JAX);
- every other module of the JAX package, and ``jax``, ``jaxlib``, ``flax``
  and ``orbax``, raise `ModuleNotFoundError` naming the module: an import
  the port does not serve fails instead of loading JAX. The app's ``--cpu``
  flags import ``jax`` and so fail too; ``--device cpu`` is the launcher's
  way to run on the CPU (`device.set_default_device`).

`serve_port()` installs the finder (and the device) for a block of code in
the caller's process and takes both away after it; `run_app()` runs one
module of the app inside such a block.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib
import importlib.abc
import importlib.machinery
import runpy
import sys
from typing import Iterator, Optional

# the app's imports of the JAX package that the port serves: name → module of the port
ALIASES = {
    "nu_scaler_core": "nu_scaler_tpu_torch.core",
    "nu_scaler_tpu.capture.video": "nu_scaler_tpu_torch.capture.video",
    "nu_scaler_tpu.runtime.detector": "nu_scaler_tpu_torch.runtime.detector",
}
STAND_INS = ("nu_scaler_tpu", "nu_scaler_tpu.capture", "nu_scaler_tpu.runtime")
REFUSED = ("nu_scaler_tpu", "nu_scaler_core", "jax", "jaxlib", "flax", "orbax")
APP = "nu_scaler"


def _under(name: str, roots) -> bool:
    return any(name == r or name.startswith(r + ".") for r in roots)


class _Alias(importlib.abc.Loader):
    """Serves a module of the port under another name: the import returns
    the port's module object itself."""

    def __init__(self, target: str) -> None:
        self.target = target

    def create_module(self, spec):
        module = importlib.import_module(self.target)
        self._spec = module.__spec__
        return module

    def exec_module(self, module) -> None:
        module.__spec__ = self._spec  # the import machinery set the alias's spec


class _StandIn(importlib.abc.Loader):
    """An empty package: a parent of an aliased module."""

    def create_module(self, spec):
        return None

    def exec_module(self, module) -> None:
        module.__doc__ = f"Stand-in for {module.__name__}: its served submodules are the port's."


class PortFinder(importlib.abc.MetaPathFinder):
    """Serves `ALIASES` and `STAND_INS`, and refuses the rest of `REFUSED`."""

    def find_spec(self, fullname, path=None, target=None):
        if fullname in ALIASES:
            return importlib.machinery.ModuleSpec(fullname, _Alias(ALIASES[fullname]))
        if fullname in STAND_INS:
            return importlib.machinery.ModuleSpec(fullname, _StandIn(), is_package=True)
        if _under(fullname, REFUSED):
            raise ModuleNotFoundError(
                f"{fullname} is not served on the PyTorch port (nu_scaler_tpu_torch.run serves "
                f"{', '.join(ALIASES)}); to run on the CPU, pass the launcher's --device cpu "
                f"instead of an app's --cpu",
                name=fullname,
            )
        return None


def _ours(name: str) -> bool:
    """Modules the finder decides, and the app's, whose imports it serves."""
    return _under(name, REFUSED + (APP,))


@contextlib.contextmanager
def serve_port(device: Optional[str] = None) -> Iterator[PortFinder]:
    """Install `PortFinder` first in `sys.meta_path`, and make `device` the
    default device when given, for the block. The modules of the JAX
    package and of the app already loaded are set aside for the block (so
    that the app imports anew, from the port) and put back after it; what the
    block imported under those names is dropped."""
    from nu_scaler_tpu_torch import device as _device

    saved = {name: mod for name, mod in sys.modules.items() if _ours(name)}
    for name in saved:
        del sys.modules[name]
    finder = PortFinder()
    sys.meta_path.insert(0, finder)
    previous = _device.set_default_device(device) if device is not None else None
    try:
        yield finder
    finally:
        if device is not None:
            _device.set_default_device(previous)
        sys.meta_path.remove(finder)
        for name in [n for n in sys.modules if _ours(n)]:
            del sys.modules[name]
        sys.modules.update(saved)


def _exit_code(code) -> int:
    if code is None:
        return 0
    if isinstance(code, int):
        return code
    print(code, file=sys.stderr)
    return 1


def run_app(module: str, args=()) -> int:
    """Run `module` as `__main__` in this process with `args` as its
    arguments; returns its exit code. The caller installs the finder
    (`serve_port`)."""
    argv_before = sys.argv
    sys.argv = [module, *args]
    try:
        runpy.run_module(module, run_name="__main__", alter_sys=True)
    except SystemExit as e:
        return _exit_code(e.code)
    finally:
        sys.argv = argv_before
    return 0


def main(argv=None) -> int:
    """Run `<module>` as `__main__` on the port; returns its exit code."""
    p = argparse.ArgumentParser(prog="python -m nu_scaler_tpu_torch.run", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--device", choices=["cuda", "cpu"], default=None,
                   help="the device of every call that names none (default: the card)")
    p.add_argument("module", help="the app's module to run, e.g. nu_scaler.transcode")
    p.add_argument("args", nargs=argparse.REMAINDER, help="its arguments")
    args = p.parse_args(argv)
    with serve_port(args.device):
        return run_app(args.module, args.args)


if __name__ == "__main__":
    sys.exit(main())
