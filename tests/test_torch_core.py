"""The port's own copies of the Kvik policy layer (``repro_torch.core``)
against ``repro.core``, and the rule that the port imports neither JAX nor
the JAX package."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

import repro.core as jcore
import repro_torch.core as tcore
from repro_torch.configs.registry import NOT_PORTED, get_config

ROOT = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("total,first,growth,align,cap", [
    (1000, 32, 2.0, 32, 256), (97, 16, 2.0, 16, 64), (4096, 128, 2.0, 128,
                                                      4096),
    (300, 7, 1.5, 1, None), (1, 32, 2.0, 32, 256)])
def test_geometric_blocks_matches_reference(total, first, growth, align, cap):
    kw = dict(first=first, growth=growth, align=align, cap=cap)
    assert tcore.geometric_blocks(total, **kw) == \
        jcore.geometric_blocks(total, **kw)


@pytest.mark.parametrize("n,demand", [(8, 3), (1, 4), (17, 5), (64, 64),
                                      (10, 1)])
def test_demand_split_matches_reference(n, demand):
    t = tcore.demand_split(tcore.SeqWork(0, n), demand)
    j = jcore.demand_split(jcore.SeqWork(0, n), demand)
    assert t.leaf_sizes() == j.leaf_sizes()
    assert [(w.start, w.stop) for w in t.leaves()] == \
        [(w.start, w.stop) for w in j.leaves()]
    assert t.divisions == j.divisions


@pytest.mark.parametrize("n,depth,align", [(2048, 0, 1), (300, 2, 1),
                                           (1000, 3, 32), (96, 5, 16)])
def test_bound_depth_plan_matches_reference(n, depth, align):
    t = tcore.build_plan(tcore.bound_depth(tcore.SeqWork(0, n, align=align),
                                           depth))
    j = jcore.build_plan(jcore.bound_depth(jcore.SeqWork(0, n, align=align),
                                           depth))
    assert t.leaf_sizes() == j.leaf_sizes()
    assert t.depth() == j.depth()
    assert t.map_reduce(lambda w: w.size(), lambda a, b: a + b) == n


def test_by_blocks_matches_reference():
    kw = dict(first=32, growth=2.0, align=32, cap=256)
    t, j = tcore.ByBlocks(**kw), jcore.ByBlocks(**kw)
    tb = [(b.start, b.stop) for b in t.blocks(tcore.SeqWork(40, 1000))]
    jb = [(b.start, b.stop) for b in j.blocks(jcore.SeqWork(40, 1000))]
    assert tb == jb
    stop = lambda c: c >= 300                         # noqa: E731
    tc, ts = t.run(tcore.SeqWork(0, 1000), lambda b, c: c + b.size(), 0,
                   should_stop=stop)
    jc, js = j.run(jcore.SeqWork(0, 1000), lambda b, c: c + b.size(), 0,
                   should_stop=stop)
    assert tc == jc and ts == tcore.BlockStats(**vars(js))


def test_cap_counter_and_hooks_match_reference():
    """threshold_fn shrinks the live cap, on_event sees every counter
    change, on_finish returns leases — the same trace in both packages."""
    def drive(core):
        events, limit = [], [10]
        c = core.Cap(core.WorkRange(0, 100), 4,
                     threshold_fn=lambda: limit[0],
                     on_event=lambda kind, live: events.append((kind, live)))
        trace = [c.should_be_divided()]
        lease, rest = c.divide_at(10)
        lease2, rest = rest.divide_at(5)
        trace.append(rest.should_be_divided())
        limit[0] = 2
        trace.append(rest.should_be_divided())
        lease.on_finish()
        lease2.on_finish()
        trace.append(rest.should_be_divided())
        return events, trace, rest.counter.value, (lease.size(), rest.size())

    assert drive(tcore) == drive(jcore)


@pytest.mark.parametrize("n,tile,depth", [(1 << 12, 256, 4), (1 << 13, 256, 5),
                                          (96, 16, 3), (1 << 10, 1, 7)])
def test_even_levels_plan_matches_reference(n, tile, depth):
    def plan(core):
        work = core.bound_depth(core.SeqWork(0, n, align=tile,
                                             min_size=tile), depth)
        return core.build_plan(core.even_levels(work))

    t, j = plan(tcore), plan(jcore)
    assert t.leaf_sizes() == j.leaf_sizes()
    assert [n.depth for n in t.leaf_nodes()] == \
        [n.depth for n in j.leaf_nodes()]
    assert all(n.depth % 2 == 0 for n in t.leaf_nodes())
    assert [[m.span() for m in lvl] for lvl in t.levels()] == \
        [[m.span() for m in lvl] for lvl in j.levels()]
    assert [(lv.pairs, lv.uniform, lv.num_pairs) for lv in
            t.merge_schedule()] == [(lv.pairs, lv.uniform, lv.num_pairs)
                                    for lv in j.merge_schedule()]


@pytest.mark.parametrize("sort_bits,digit_bits,key_shift", [
    (12, 4, 20), (17, 4, 9), (6, 4, 18), (32, 4, 0), (0, 4, 3), (13, 5, 2)])
def test_digit_passes_match_reference(sort_bits, digit_bits, key_shift):
    t = tcore.digit_passes(sort_bits, digit_bits, key_shift=key_shift)
    j = jcore.digit_passes(sort_bits, digit_bits, key_shift=key_shift)
    assert [(p.shift, p.bits, p.radix) for p in t] == \
        [(p.shift, p.bits, p.radix) for p in j]
    with pytest.raises(ValueError):
        tcore.digit_passes(4, 0)


@pytest.mark.parametrize("mode", ["merge", "multi_tile"])
@pytest.mark.parametrize("n,tile,sort_bits", [(1 << 20, 1024, 12),
                                              (1 << 15, 512, 17),
                                              (4096, 4096, 8)])
def test_sort_schedule_matches_reference(n, tile, sort_bits, mode):
    def sched(core):
        depth = (n // tile).bit_length() - 1
        work = core.bound_depth(core.SeqWork(0, n, align=tile,
                                             min_size=tile), depth)
        return core.build_plan(core.even_levels(work) if mode == "merge"
                               else work).sort_schedule(
            sort_bits=sort_bits, digit_bits=4,
            key_shift=tile.bit_length() - 1, mode=mode)

    t, j = sched(tcore), sched(jcore)
    assert (t.num_passes, t.num_launches, t.mode, t.num_tiles,
            t.key_shift) == (j.num_passes, j.num_launches, j.mode,
                             j.num_tiles, j.key_shift)
    assert [(p.shift, p.bits) for p in t.tile_passes] == \
        [(p.shift, p.bits) for p in j.tile_passes]
    assert [lv.pairs for lv in t.levels] == [lv.pairs for lv in j.levels]
    assert tcore.MULTI_TILE_LAUNCHES_PER_PASS == \
        jcore.MULTI_TILE_LAUNCHES_PER_PASS
    with pytest.raises(ValueError):
        tcore.SortSchedule(tile_passes=(), levels=(), mode="bogus")


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_imports_neither_jax_nor_the_jax_package():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files += [ROOT / "chip_smoke.py", ROOT / "tools" / "sort_turns.py",
              ROOT / "tools" / "k1_turns.py",
              ROOT / "tools" / "version_turns.py"]
    assert len(files) > 20
    names = {f.name for f in files}
    assert {"merge_sort.py", "radix_sort.py", "ops.py", "tile_scan.py",
            "whisper_medium.py", "llama32_vision_11b.py",
            "jamba_1_5_large.py"} <= names
    bad = [(f.relative_to(ROOT), m) for f in files for m in _imports(f)
           if m.split(".")[0] in ("jax", "jaxlib", "repro", "ml_dtypes")]
    assert bad == []


def test_core_is_plain_python():
    """``repro_torch.core`` imports neither torch nor JAX: it runs with both
    unimportable, and no module of it names either."""
    files = sorted((ROOT / "src" / "repro_torch" / "core").glob("*.py"))
    assert {"runtime.py", "policies.py", "faults.py", "dnc.py"} <= \
        {f.name for f in files}
    bad = [(f.name, m) for f in files for m in _imports(f)
           if m.split(".")[0] in ("torch", "jax", "jaxlib", "repro")]
    assert bad == []
    code = ("import sys; sys.modules['jax'] = None; "
            "sys.modules['torch'] = None\n"
            "import repro_torch.core as c\n"
            "r = c.simulate(c.thief_splitting(c.WorkRange(0, 500), p=4), "
            "c.AdaptivePolicy(), 4, c.CostModel())\n"
            "assert r.items_processed == 500\n"
            "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=60)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def test_port_runs_with_jax_unimportable():
    """``sys.modules["jax"] = None`` makes any import of JAX raise: the port
    still imports and runs a CPU decode step."""
    code = (
        "import sys; sys.modules['jax'] = None\n"
        "import torch\n"
        "import repro_torch.serve, repro_torch.weights\n"
        "from repro_torch.configs.registry import get_smoke_config\n"
        "from repro_torch.models.model import Model\n"
        "m = Model(get_smoke_config('llama3-8b'), device='cpu')\n"
        "p = m.init(0)\n"
        "logits, cache = m.prefill(p, torch.tensor([[5, 6, 7, 8]]), "
        "max_seq=8)\n"
        "out, _ = m.decode_step(p, torch.tensor([3], dtype=torch.int32), "
        "cache, torch.tensor([4], dtype=torch.int32))\n"
        "assert out.shape == (1, 512) and torch.isfinite(out).all()\n"
        "from repro_torch.kernels.ops import stable_argsort\n"
        "order = stable_argsort(torch.tensor([3, 1, 2, 1]), num_key_bits=2)\n"
        "assert order.tolist() == [1, 3, 2, 0]\n"
        "assert not any(k.startswith('repro.') for k in sys.modules)\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")


def test_unported_arch_names_its_roadmap_item():
    assert get_config("llama3-8b").num_layers == 32
    for arch, item in NOT_PORTED.items():
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            get_config(arch)
        assert "Queue 1" in item
    with pytest.raises(KeyError):
        get_config("no-such-arch")
