"""power(z) on the sites where ``chip_smoke.py`` holds the cuda backend
against the plain one (phase 7, scale 0.1), under three distance passes:
how far the JAX package's own result moves with the distance pass's
rounding, and where the port's lies."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import clustering as jclustering
from repro.core import coreset as jcoreset
from repro.core import distributed as jdistributed
from repro.core import partition as jpartition
from repro.core import topology as jtopology
from repro_torch.core import clustering, coreset, distributed, prng, topology
from repro_torch.data.synthetic import paper_dataset
from test_torch_objectives import _DIRECT

# torch runs single-threaded in these tests: with JAX's CPU runtime in the
# same process, the two thread pools contend and torch's ops run 10-40x
# slower
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def paper_sites():
    """The sites of ``chip_smoke.py``'s scale-0.1 comparison: the
    yearpredictionmsd stand-in (51,534 x 90, k = 50), 100 weighted sites
    on ``grid(10, 10)``, t = 3 k n."""
    data, k = paper_dataset("yearpredictionmsd", seed=0, scale=0.1)
    g = jtopology.grid(10, 10)
    sp, sm = jpartition.pad_partition(data, jpartition.partition_indices(
        data, g.n, "weighted", seed=1, degrees=g.degrees()))
    return sp, sm, k, 3 * k * g.n


@pytest.fixture(scope="module")
def paper_passes(paper_sites):
    """power(3) and power(1.5) on ``paper_sites`` under three distance
    passes -- the JAX package's matmul form ("jnp"), its exact form
    ("exact", ``_DirectJax``) and the port's matmul form ("port"): per
    pass the flood pipeline's t_i (its Round-1 local costs allocated) and
    full-data cost."""
    data, _ = paper_dataset("yearpredictionmsd", seed=0, scale=0.1)
    sp, sm, k, t = paper_sites
    g = jtopology.grid(10, 10)
    out = {}
    for name in ("power(3)", "power(1.5)"):
        for label, b in (("jnp", "jnp"), ("exact", _DIRECT[0])):
            res = jdistributed.graph_distributed_kmeans(
                jax.random.PRNGKey(0), jnp.asarray(sp), jnp.asarray(sm), k,
                t, g, objective=name, backend=b)
            out[name, label] = (
                np.asarray(jcoreset.proportional_allocation(
                    res.local_costs, t)),
                float(jclustering.cost(jnp.asarray(data), res.centers,
                                       objective=name, backend="jnp")))
        res = distributed.graph_distributed_kmeans(
            prng.PRNGKey(0), sp, sm, k, t, topology.grid(10, 10),
            objective=name, device="cpu")
        out[name, "port"] = (
            coreset.proportional_allocation(res.local_costs, t).numpy(),
            float(clustering.cost(data, res.centers, objective=name,
                                  device="cpu")))
    return out


def test_power_3_across_distance_passes_on_the_paper_sites(paper_passes):
    """The sites where ``chip_smoke.py`` holds the cuda backend against
    the plain one. power(3): Round 1's t_i are equal under all three
    passes, and the port's full-data cost is the reference's to 1e-3
    (1.1e-4 measured), but the final D^3 solve rests on the distance
    pass's rounding: the reference's own exact pass lands more than 1%
    away from its matmul pass (1.9% measured)."""
    (tj, cj), (te, ce), (tp, cp) = (paper_passes["power(3)", x]
                                    for x in ("jnp", "exact", "port"))
    np.testing.assert_array_equal(tp, tj)
    np.testing.assert_array_equal(te, tj)
    assert abs(cp - cj) <= 1e-3 * cj
    assert abs(ce - cj) > 1e-2 * cj


def test_power_below_two_across_distance_passes_on_the_paper_sites(
        paper_passes):
    """power(1.5), z < 2: the IRLS mass (d2 + 1e-6)^((z-2)/2) of a point
    on its centre (seeding leaves them so) is 31.6 at d2 = 0 and 5.6 at
    d2 = 1e-3 (cancellation noise of |p|^2 ~ 2,700), so Round 1 itself
    rests on the rounding: the reference's two passes give t_i up to 28
    apart at a site and the port's pass up to 23 from the reference's,
    and the three full-data costs lie more than 5% apart pairwise
    (measured: reference 2.2568e6 and 2.4111e6, port 1.9202e6)."""
    (tj, cj), (te, ce), (tp, cp) = (paper_passes["power(1.5)", x]
                                    for x in ("jnp", "exact", "port"))
    assert tj.sum() == te.sum() == tp.sum()
    assert np.abs(tj - te).max() > 10
    assert np.abs(tp - tj).max() <= np.abs(tj - te).max()
    costs = sorted([cj, ce, cp])
    assert costs[1] > 1.05 * costs[0] and costs[2] > 1.05 * costs[1]
