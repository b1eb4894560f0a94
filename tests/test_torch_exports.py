"""The port's package exports against the JAX package's: for ``core``,
``stream``, ``serve``, ``kernels``, ``data`` and ``wan`` the port's ``__all__``
covers the reference's, except the names still to be ported, each tagged
with the ROADMAP item that ports it. Every exported name resolves."""
import importlib

import pytest

# reference exports not yet ported, by ROADMAP item
PENDING = {
    "A8": {"data": {"BigramLM"},
           "serve": {"Engine", "Request", "generate", "make_serve_steps"}},
}
PACKAGES = ("core", "stream", "serve", "kernels", "data", "wan")


def _pending(package):
    return set().union(*(items.get(package, set())
                         for items in PENDING.values()))


@pytest.mark.parametrize("package", PACKAGES)
def test_the_port_exports_what_the_reference_does(package):
    ours = importlib.import_module(f"repro_torch.{package}")
    theirs = importlib.import_module(f"repro.{package}")
    missing = set(theirs.__all__) - set(ours.__all__) - _pending(package)
    assert not missing, sorted(missing)


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
    assert pending <= set(theirs.__all__), sorted(pending - set(
        theirs.__all__))
    assert not pending & set(ours.__all__), sorted(pending & set(
        ours.__all__))
