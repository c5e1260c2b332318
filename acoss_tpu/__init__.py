"""The package's former name, kept as an alias of :mod:`acoss_jax`.

``import <this>.cli`` and ``from <this>.ops import alignment`` give the
very module objects of ``acoss_jax`` (one copy of each module, so its
state is shared), and ``python -m <this>`` runs the same CLI. New code
imports ``acoss_jax``.
"""

import importlib
import importlib.abc
import importlib.util
import sys

import acoss_jax

_TARGET = "acoss_jax"
_PREFIX = __name__ + "."


class _Alias(importlib.abc.MetaPathFinder, importlib.abc.Loader):
    """Resolves every submodule of this package to the ``acoss_jax``
    module of the same dotted path."""

    def find_spec(self, fullname, path=None, target=None):
        if fullname.startswith(_PREFIX) and fullname != _PREFIX + "__main__":
            return importlib.util.spec_from_loader(fullname, self)
        return None

    def create_module(self, spec):
        module = importlib.import_module(_TARGET + spec.name[len(__name__):])
        spec.loader_state = module.__spec__
        return module

    def exec_module(self, module):
        # the import system stamped the alias spec on the module; give it
        # back its own
        module.__spec__ = module.__spec__.loader_state


sys.meta_path.insert(0, _Alias())


def __getattr__(name):
    return getattr(acoss_jax, name)
