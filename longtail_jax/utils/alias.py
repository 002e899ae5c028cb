"""Import this package under a second name.

``install(old)`` makes ``import old.x`` return the very module object that
``longtail_jax.x`` is (no second copy, so classes and module state are
shared), and lets ``python -m old.cli`` run ``longtail_jax.cli``.  The
package's former name uses it, so code written against that name keeps
working.
"""

from __future__ import annotations

import importlib
import importlib.abc
import importlib.util
import sys

_PACKAGE = __name__.split(".")[0]


class _Alias(importlib.abc.MetaPathFinder, importlib.abc.Loader):
    def __init__(self, old: str):
        self.old = old
        self._specs: dict = {}

    def _real(self, fullname: str) -> str:
        return _PACKAGE + fullname[len(self.old):]

    def find_spec(self, fullname, path=None, target=None):
        if not fullname.startswith(self.old + "."):
            return None
        if importlib.util.find_spec(self._real(fullname)) is None:
            return None
        return importlib.util.spec_from_loader(fullname, self)

    def create_module(self, spec):
        module = importlib.import_module(self._real(spec.name))
        self._specs[spec.name] = module.__spec__
        return module

    def exec_module(self, module):
        # the import system stamped the alias spec on the shared module
        module.__spec__ = self._specs.pop(module.__spec__.name)

    def get_code(self, fullname):       # python -m old.x
        real = self._real(fullname)
        return importlib.util.find_spec(real).loader.get_code(real)


def install(old: str) -> None:
    """Serve ``old`` and every ``old.x`` as ``longtail_jax`` and
    ``longtail_jax.x``."""
    sys.meta_path.insert(0, _Alias(old))
    sys.modules[old] = importlib.import_module(_PACKAGE)
