"""The port's cells and dry run (``repro_torch.launch``: ``shapes``,
``mesh``, ``specs``, ``dryrun``) against the reference's.

The six cells of ``test_dryrun_small.py`` -- reduced configs, seq 64,
batch 8, on a (2, 4) mesh -- run through both packages: the reference's
compiled in one JAX subprocess with 8 forced host devices, as that test
compiles them, the port's on meta tensors. Per-device argument bytes
equal the reference's ``argument_size_in_bytes``; flops per device are
within FLOPS_RTOL of its ``hlo_dot_flops``; every train cell's link
bytes are > 0 on both sides, and the link and temp bytes are printed
beside the reference's (the port reads both from one rank of its own
sharded step on a stand-in grid, the reference from its compiled
program: ROADMAP C states the ratios); every train cell's temp bytes lie
below what the unsharded step at one rank's batch counted before the
dry run read the sharded step (PARENT_TEMP). ``fits_hbm`` is taken
against ``H100_SXM``'s memory, and a production cell is built with
nothing allocated."""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import jax
import pytest
import torch

from repro import configs as jconfigs
from repro.launch import shapes as jshapes
from repro.models import cache_spec as jcache_spec
from repro.models import init_params as jinit_params
from repro.roofline.report import RooflineReport as JRooflineReport
from repro_torch import configs
from repro_torch import tree as tree_mod
from repro_torch.launch import dryrun, shapes, specs
from repro_torch.launch.mesh import make_mesh, make_production_mesh
from repro_torch.launch.shapes import ShapeSpec
from repro_torch.models import init_params, param_spec
from repro_torch.roofline.report import H100_SXM

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELLS = [("llama3_8b", "train"), ("dbrx_132b", "train"),
         ("mamba2_370m", "train"), ("gemma3_27b", "prefill"),
         ("recurrentgemma_2b", "decode"), ("qwen2_vl_2b", "decode")]
# counted dot flops per device against the reference's compiled ones:
# equal at five cells; mamba2's SSD is 0.15% under (the reference's
# compiled scan holds a few more dots than the port's chunked form)
FLOPS_RTOL = 2e-3
# each train cell's temp bytes when the dry run ran the unsharded step
# at one rank's batch, every parameter and gradient whole: the sharded
# step's rank holds shards
PARENT_TEMP = {"llama3_8b": 3_020_056, "dbrx_132b": 3_020_060,
               "mamba2_370m": 4_243_740}

SCRIPT = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import json, sys
    from repro import configs
    from repro.launch.mesh import make_mesh
    from repro.launch.shapes import ShapeSpec
    from repro.launch import specs as S
    from repro.roofline.report import build_report

    mesh = make_mesh((2, 4), ("data", "model"))
    out = {}
    for cell in sys.argv[1:]:
        arch, kind = cell.split(":")
        cfg = configs.get_reduced(arch)
        S.SHAPES["ci"] = ShapeSpec("ci", kind, seq_len=64, global_batch=8)
        c = S.build_cell(arch, "ci", mesh, cfg_override=cfg)
        compiled = c.lower().compile()
        ma = compiled.memory_analysis()
        ca = compiled.cost_analysis()
        if isinstance(ca, (list, tuple)):
            ca = ca[0] if ca else {}
        rep = build_report(arch, "ci", "small", cfg, kind, 64, 8, 8,
                           compiled.as_text(), dict(ca or {}),
                           float(ma.temp_size_in_bytes), None)
        out[cell] = {"arg_bytes": float(ma.argument_size_in_bytes),
                     "flops": rep.hlo_dot_flops, "ici": rep.ici_bytes,
                     "counts": rep.collective_counts,
                     "temp_size_in_bytes": float(ma.temp_size_in_bytes)}
    print("CELLS " + json.dumps(out))
""")


def _name(arch, kind):
    return f"{arch}:{kind}"


@pytest.fixture(scope="module")
def reference():
    env = dict(os.environ)
    env["PYTHONPATH"] = "src"
    env.pop("XLA_FLAGS", None)
    r = subprocess.run([sys.executable, "-c", SCRIPT,
                        *(_name(*c) for c in CELLS)], env=env, cwd=ROOT,
                       capture_output=True, text=True, timeout=600)
    assert "CELLS " in r.stdout, r.stdout[-2000:] + r.stderr[-3000:]
    return json.loads(r.stdout.split("CELLS ")[1])


@pytest.fixture(scope="module")
def port():
    mesh = make_mesh((2, 4), ("data", "model"))
    out = {}
    try:
        for arch, kind in CELLS:
            specs.SHAPES["ci"] = ShapeSpec("ci", kind, seq_len=64,
                                           global_batch=8)
            out[_name(arch, kind)] = dryrun.run_cell(
                arch, "ci", "small", "", verbose=False, hardware=H100_SXM,
                cfg_override=configs.get_reduced(arch), mesh=mesh)
    finally:
        specs.SHAPES.pop("ci", None)
    return out


@pytest.mark.parametrize("arch,kind", CELLS)
def test_argument_bytes_are_the_references(arch, kind, reference, port):
    assert port[_name(arch, kind)]["arg_bytes"] == \
        reference[_name(arch, kind)]["arg_bytes"]


@pytest.mark.parametrize("arch,kind", CELLS)
def test_flops_per_device_are_the_references(arch, kind, reference, port):
    got = port[_name(arch, kind)]["hlo_dot_flops"]
    want = reference[_name(arch, kind)]["flops"]
    assert got > 0 and abs(got - want) <= FLOPS_RTOL * want, (got, want)


@pytest.mark.parametrize("arch,kind", CELLS)
def test_link_bytes_side_by_side(arch, kind, reference, port):
    """Both sides' link and temp bytes, printed; every train cell
    communicates, and its temp bytes are below PARENT_TEMP's."""
    got = port[_name(arch, kind)]
    want = reference[_name(arch, kind)]
    print(f"{arch} {kind}: link bytes port {got['ici_bytes']:.0f} "
          f"reference {want['ici']:.0f} ratio "
          f"{got['ici_bytes'] / want['ici']:.3f}; temp bytes port "
          f"{got['temp_bytes']:.0f} reference "
          f"{want['temp_size_in_bytes']:.0f} ratio "
          f"{got['temp_bytes'] / want['temp_size_in_bytes']:.3f}; counts "
          f"port {got['collective_counts']} reference {want['counts']}")
    if kind == "train":
        assert got["ici_bytes"] > 0 and want["ici"] > 0
        assert 0 < got["temp_bytes"] < PARENT_TEMP[arch]
    assert got["dcn_bytes"] == 0.0


@pytest.mark.parametrize("arch,kind", CELLS)
def test_fits_hbm_is_taken_against_the_h100(arch, kind, port):
    r = port[_name(arch, kind)]
    peak = (r["temp_bytes"] + r["arg_bytes"] + r["out_bytes"]
            - r["alias_bytes"])
    assert r["peak_memory_bytes"] == peak > 0
    assert r["fits_hbm"] == (peak <= H100_SXM.memory_bytes) is True
    assert r["hardware"] == H100_SXM.name
    assert 0 < r["alias_bytes"] <= r["out_bytes"] or kind == "prefill"


def test_fits_hbm_follows_the_cards_memory():
    small = dataclasses.replace(H100_SXM, memory_bytes=1e3)
    mesh = make_mesh((2, 4), ("data", "model"))
    specs.SHAPES["ci"] = ShapeSpec("ci", "decode", seq_len=64,
                                   global_batch=8)
    try:
        r = dryrun.run_cell("qwen2_vl_2b", "ci", "small", "", verbose=False,
                            hardware=small, mesh=mesh,
                            cfg_override=configs.get_reduced("qwen2_vl_2b"))
    finally:
        specs.SHAPES.pop("ci", None)
    assert r["fits_hbm"] is False


def test_the_report_has_the_references_keys(tmp_path):
    dryrun.main(["--arch", "mamba2_370m", "--shape", "decode_32k",
                 "--hardware", "h100_sxm", "--out", str(tmp_path)])
    with open(tmp_path / "mamba2_370m__decode_32k__single.json") as f:
        got = json.load(f)
    want = {f.name for f in dataclasses.fields(JRooflineReport)} | {
        "lower_s", "compile_s", "arg_bytes", "out_bytes", "temp_bytes",
        "alias_bytes", "fits_hbm", "status"}
    assert want <= set(got) and got["status"] == "ok"
    assert got["n_devices"] == 256 and got["hlo_dot_flops"] > 0


def test_a_multi_pod_cell_needs_the_network_rate():
    """Gradients all-reduce over the pod axis: link bytes across the
    network, which need its rate (none is assumed)."""
    mesh = make_mesh((2, 2, 2), ("pod", "data", "model"))
    cfg = configs.get_reduced("llama3_8b")
    specs.SHAPES["ci"] = ShapeSpec("ci", "train", seq_len=64, global_batch=8)
    try:
        with pytest.raises(ValueError, match="network"):
            dryrun.run_cell("llama3_8b", "ci", "multi", "", verbose=False,
                            hardware=H100_SXM, cfg_override=cfg, mesh=mesh)
        r = dryrun.run_cell("llama3_8b", "ci", "multi", "", verbose=False,
                            hardware=H100_SXM, cfg_override=cfg, mesh=mesh,
                            network_bytes_per_s=50e9)
    finally:
        specs.SHAPES.pop("ci", None)
    assert r["dcn_bytes"] > 0 and r["ici_bytes"] > 0
    with pytest.raises(SystemExit):
        dryrun.main(["--arch", "llama3_8b", "--mesh", "multi",
                     "--hardware", "h100_sxm", "--out", ""])


def test_build_cell_of_a_production_config_allocates_nothing():
    mesh = make_production_mesh()
    cell = specs.build_cell("llama3_8b", "train_4k", mesh)
    leaves = tree_mod.leaves(list(cell.args))
    assert leaves and all(t.device.type == "meta" for t in leaves)
    params = tree_mod.leaves(cell.args[0])
    assert sum(t.numel() for t in params) == cell.cfg.param_count()
    assert cell.microbatches == 8
    # per device: f32 params, m and v laid out over 256 devices, and the
    # batch's rows over the 16 of the data axis
    arg = sum(specs.tree_bytes(a, s, mesh)
              for a, s in zip(cell.args, cell.specs))
    assert 3 * 4 * cell.cfg.param_count() / 256 < arg \
        < 3 * 4 * cell.cfg.param_count() / 16
    if torch.cuda.is_available():
        assert torch.cuda.memory_allocated() == 0


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_param_spec_is_init_params_shapes(arch):
    cfg = configs.get_reduced(arch)
    got = param_spec(cfg)
    want = init_params(0, cfg, "cpu")
    assert [p for p, _ in tree_mod.paths(got)] == \
        [p for p, _ in tree_mod.paths(want)]
    for a, b in zip(tree_mod.leaves(got), tree_mod.leaves(want)):
        assert a.device.type == "meta"
        assert a.shape == b.shape and a.dtype == b.dtype


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_stacked_params_are_the_references_tree(arch):
    """The cell's parameter arguments have the reference's stacked tree:
    the same paths, shapes and dtypes as ``jax.eval_shape`` of its
    ``init_params``; the per-layer views are the port's params."""
    cfg = configs.get_reduced(arch)
    stacked = specs.stacked_params(param_spec(cfg), cfg)
    want = jax.eval_shape(lambda: jinit_params(
        jax.random.PRNGKey(0), jconfigs.get_reduced(arch)))
    flat = jax.tree_util.tree_flatten_with_path(want)[0]
    wpaths = [tuple(getattr(k, "key", str(k)) for k in path)
              for path, _ in flat]
    assert [p for p, _ in tree_mod.paths(stacked)] == wpaths
    for a, (_, b) in zip(tree_mod.leaves(stacked), flat):
        assert tuple(a.shape) == b.shape
        assert str(a.dtype).removeprefix("torch.") == str(b.dtype)
    views = specs.per_layer_views(stacked, cfg)
    port = init_params(0, cfg, "cpu")
    for a, b in zip(tree_mod.leaves(views), tree_mod.leaves(port)):
        assert a.shape == b.shape and a.dtype == b.dtype


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_the_int8_cache_switch_is_the_references(arch):
    """Decode cells serve with the int8 cache where the reference's rule
    switches: the bf16 cache over 2.5 GB a device."""
    mesh = make_production_mesh()
    for name in shapes.cells_for(arch):
        shape = shapes.SHAPES[name]
        if shape.kind != "decode":
            continue
        cell = specs.build_cell(arch, name, mesh)
        jc = jconfigs.get(arch)
        cache = jcache_spec(jc, shape.global_batch, shape.seq_len)
        nbytes = sum(a.size * a.dtype.itemsize
                     for a in jax.tree.leaves(cache)) / mesh.size
        want = "int8" if nbytes > 2.5e9 else jc.kv_cache_dtype
        assert cell.cfg.kv_cache_dtype == want, (arch, name)
        assert all(t.device.type == "meta"
                   for t in tree_mod.leaves(list(cell.args)))


def test_shapes_and_meshes_are_the_references():
    assert shapes.SHAPES.keys() == jshapes.SHAPES.keys()
    for k, v in shapes.SHAPES.items():
        assert dataclasses.asdict(v) == dataclasses.asdict(jshapes.SHAPES[k])
    assert shapes.LONG_CONTEXT_OK == jshapes.LONG_CONTEXT_OK
    assert shapes.all_cells() == jshapes.all_cells()
    for arch in configs.ARCH_IDS:
        assert shapes.cells_for(arch) == jshapes.cells_for(arch)
    single, multi = make_production_mesh(), make_production_mesh(
        multi_pod=True)
    assert single.axis_names == ("data", "model") and single.size == 256
    assert single.shape == {"data": 16, "model": 16}
    assert multi.shape == {"pod": 2, "data": 16, "model": 16}
    assert multi.size == 512
    small = make_mesh((2, 4), ("data", "model"))
    ref = jax.sharding.AbstractMesh((2, 4), ("data", "model"))
    assert small.shape == dict(ref.shape) and small.size == ref.size
    with pytest.raises(ValueError):
        make_mesh((2, 4), ("data",))


def test_importing_the_launchers_touches_no_cuda_state():
    code = ("import torch, repro_torch.launch, repro_torch.launch.dryrun, "
            "repro_torch.launch.train, repro_torch.launch.serve; "
            "print(torch.cuda.is_initialized())")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       env={**os.environ, "PYTHONPATH": "src"},
                       capture_output=True, text=True, timeout=120)
    assert r.stdout.strip() == "False", r.stderr[-2000:]
