"""The port's package exports against the JAX package's: for ``core``,
``stream``, ``serve``, ``kernels``, ``data``, ``wan``, ``roofline``,
``configs``, ``models``, ``train``, ``optim``, ``checkpoint`` and
``launch`` the port's ``__all__`` covers the reference's
(where the reference has no ``__all__``, the functions and constants its
package defines), except the names still to be ported, each tagged with
the ROADMAP item that ports it, and the names with a counterpart of
another name. Every exported name resolves."""
import importlib

import pytest

# reference exports not yet ported, by ROADMAP item
PENDING = {}
# reference name -> (the port's name, why it differs), per package
COUNTERPARTS = {
    "roofline": {"hlo": ("trace", "the port runs eagerly and has no HLO to "
                         "parse: trace records the same flops, bytes and "
                         "collectives by phase as the program runs")},
}
PACKAGES = ("core", "stream", "serve", "kernels", "data", "wan", "roofline",
            "configs", "models", "train", "optim", "checkpoint", "launch")


def _pending(package):
    return set().union(*(items.get(package, set())
                         for items in PENDING.values()))


def _exports(module):
    """``__all__``, or where a package has none the functions and
    constants it defines itself."""
    if hasattr(module, "__all__"):
        return set(module.__all__)
    return {name for name, value in vars(module).items()
            if not name.startswith("_") and (
                name.isupper()
                or getattr(value, "__module__", None) == module.__name__)}


@pytest.mark.parametrize("package", PACKAGES)
def test_the_port_exports_what_the_reference_does(package):
    ours = importlib.import_module(f"repro_torch.{package}")
    theirs = importlib.import_module(f"repro.{package}")
    missing = (_exports(theirs) - set(ours.__all__) - _pending(package)
               - set(COUNTERPARTS.get(package, {})))
    assert not missing, sorted(missing)


@pytest.mark.parametrize("package", sorted(COUNTERPARTS))
def test_each_counterpart_stands_for_a_reference_name(package):
    """A counterpart replaces a name the reference exports and the port
    does not, and the port exports it in its place."""
    ours = importlib.import_module(f"repro_torch.{package}")
    theirs = importlib.import_module(f"repro.{package}")
    for name, (port_name, why) in COUNTERPARTS[package].items():
        assert name in _exports(theirs) and name not in ours.__all__, name
        assert port_name in ours.__all__ and why, name


@pytest.mark.parametrize("package", PACKAGES)
def test_every_exported_name_resolves(package):
    ours = importlib.import_module(f"repro_torch.{package}")
    assert len(set(ours.__all__)) == len(ours.__all__)
    for name in ours.__all__:
        assert getattr(ours, name) is not None, name


@pytest.mark.parametrize("package", PACKAGES)
def test_pending_names_are_still_missing(package):
    """A pending name the port exports is done: take it off the list."""
    ours = importlib.import_module(f"repro_torch.{package}")
    theirs = importlib.import_module(f"repro.{package}")
    pending = _pending(package)
    assert pending <= _exports(theirs), sorted(pending - _exports(theirs))
    assert not pending & set(ours.__all__), sorted(pending & set(
        ours.__all__))
