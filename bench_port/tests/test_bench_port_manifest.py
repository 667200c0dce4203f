"""The manifest and the files it names; a cell, a configuration and a
metric added as files alone; the yardstick's arithmetic; the seeded inputs;
the guard against JAX and the JAX package."""

import json
import math
import shutil

import numpy as np
import pytest

from harness import device, guard, manifest, trace

BENCH = manifest.BENCH_DIR
ROOT = manifest.ROOT
# what runs and builds leave in the folder (gitignored), not the benchmark
LEFT_BEHIND = {"_cache", "_build", "_archive", "__pycache__"}


def bench_files(pattern: str = "*"):
    return [p for p in BENCH.rglob(pattern)
            if not LEFT_BEHIND & set(p.relative_to(BENCH).parts)]


def test_manifest_names_units_and_files():
    man = manifest.manifest()
    assert set(man) == {"command", "paths", "run_seconds", "configs", "workloads",
                        "end_to_end", "per_layer"}
    assert man["paths"] == ["bench_port"]
    assert 1 <= man["run_seconds"] <= 51
    names = []
    for c in man["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (ROOT / c["file"]).is_file()
        assert manifest.config(c["name"])["name"] == c["name"]
        assert 1 <= len(c["source"]) <= 200
        names.append(c["name"])
    for w in man["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in names and w["chips"] in (1, 4)
        assert len(w["why"]) <= 200
        spec = manifest.workload(w["name"])
        assert spec["config"] == w["config"] and spec["why"] == w["why"]
        names.append(w["name"])
    metrics = man["end_to_end"] + man["per_layer"]
    assert "setup_s" in {m["name"] for m in man["end_to_end"]}
    for m in metrics:
        assert manifest.UNIT_RE.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
        assert callable(manifest.metric_module(m["name"]).read)
        names.append(m["name"])
    for m in man["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0 < m["bound"] <= 0.25
    e2e = {m["name"] for m in man["end_to_end"]}
    for m in man["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]
    for n in names + [w["traffic"] for w in man["workloads"]]:
        assert manifest.NAME_RE.match(n), n
    assert len(names) == len(set(names))
    # every file under the benchmark's folder is named from a name's characters
    for p in bench_files():
        rel = p.relative_to(ROOT).as_posix()
        assert all(ch.isalnum() or ch in "_.-/" for ch in rel), rel


def test_every_cell_reports_the_contract(tmp_path):
    man = manifest.manifest()
    for w in man["workloads"]:
        e2e = [m["name"] for m in manifest.cell_metrics(man, w["name"], False)]
        layers = [m["name"] for m in manifest.cell_metrics(man, w["name"], True)]
        assert "setup_s" in e2e and len(e2e) >= 2 and layers


def test_added_files_are_found_by_name(tmp_path, monkeypatch):
    """A configuration, a cell, a maker and a metric added as new files
    (and two manifest entries) are found without editing a file."""
    bench = tmp_path / "bench_port"
    shutil.copytree(BENCH, bench, ignore=shutil.ignore_patterns("_cache", "_build",
                                                                 "__pycache__"))
    man = json.loads((ROOT / "BENCHMARK.json").read_text())
    (bench / "configs" / "new-cloud.json").write_text(json.dumps(
        {"name": "new-cloud", "domain": "grid", "reference": "grid",
         "geometry": {"maker": "two_points"}, "options": {}}))
    (bench / "geometry" / "two_points.py").write_text(
        "import numpy as np\n"
        "def make(params, rng):\n"
        "    return {'kind': 'cloud', 'positions': rng.standard_normal((2, 3))}\n")
    (bench / "workloads" / "new-cloud.x.json").write_text(json.dumps(
        {"config": "new-cloud", "options": {"h_coef": 0}, "limits": {}, "chips": 1,
         "why": "a new cell"}))
    (bench / "metrics" / "new_metric.py").write_text(
        "def read(run):\n    return 2.0 * run.n_solves\n")
    man["workloads"].append({"name": "new-cloud.x", "config": "new-cloud", "traffic": "x",
                             "chips": 1, "why": "a new cell"})
    man["per_layer"].append({"name": "new_metric", "unit": "calls", "better": "lower",
                             "source": "program_counter", "layer": "device programs",
                             "moves": "solve_s", "workloads": ["new-cloud.x"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(man))
    monkeypatch.setattr(manifest, "BENCH_DIR", bench)
    monkeypatch.setattr(manifest, "ROOT", tmp_path)
    m = manifest.manifest()
    assert manifest.cell_entry(m, "new-cloud.x")["config"] == "new-cloud"
    wl = manifest.workload("new-cloud.x")
    cfg = manifest.config(wl["config"])
    made = manifest.geometry_module(cfg["geometry"]["maker"]).make(
        cfg["geometry"], np.random.default_rng(0))
    assert made["positions"].shape == (2, 3)
    names = [x["name"] for x in manifest.cell_metrics(m, "new-cloud.x", True)]
    assert "new_metric" in names and "tmat_roofline" not in names
    assert manifest.metric_module("new_metric").read(type("R", (), {"n_solves": 3})) == 6.0


def _load(kind, name):
    return getattr(manifest, f"{kind}_module")(name)


def test_roofline_arithmetic_by_hand():
    tmat = _load("metric", "tmat_roofline")
    # m = 3: the lower triangle's 6 floats and two 3-vectors, 4 bytes each
    assert tmat.bytes_a_product(3) == 4 * 6 + 2 * 4 * 3
    # 16 iterations: 4 set-up projections and 2 an iteration, 4 products each
    assert tmat.products(16) == 4 * (4 + 32) == 144
    k1 = _load("metric", "k1_roofline")
    assert k1.pairs_per_solve(10, 7) == 70
    # 132 SMs x 16 results a clock at 1000 MHz, 2 results a pair
    sfu = device.sfu_results_per_s(1000.0)
    assert sfu == 132 * 16 * 1e9
    assert math.isclose(k1.bound_s(sfu / 2, 1000.0), 1.0)


def test_trace_union_gaps_launches_and_counting():
    dev = [(10, 20, "k_a"), (15, 30, "k_b"), (50, 60, "gemv_x"), (95, 120, "k_a")]
    rt = [(12, "cudaLaunchKernel"), (40, "cudaGraphLaunch"), (55, "cuLaunchKernel"),
          (70, "cudaLaunchKernel")]
    tr = trace.Trace(dev, rt, [(0, 50), (50, 100)])
    assert tr.busy() == [(10, 30), (50, 60), (95, 100)]
    assert tr.busy_ns() == 35 and tr.window_ns == 100
    assert tr.gaps() == [(0, 10), (30, 50), (60, 95)]
    # three launch calls, two of them markers (the second solve's and the
    # closing one; the first marker's call precedes the span)
    assert tr.launch_calls() == 3 - 2
    notes = []
    assert trace.counted(tr, "gemv", 1, "x", notes) == [(50, 60, "gemv_x")]
    assert trace.counted(tr, "gemv", 2, "x", notes) is None and notes
    bd = tr.breakdown([[("p1", 30e-9), ("p2", 20e-9)], [("q", 50e-9)]])
    assert bd["device_ops"][0][0] == "k_a"
    # the longest gap, in solve 1's phase; the next in solve 0's second
    # phase (30..50 ns), then its first
    assert bd["idle_gaps"] == [["q", 35e-9], ["p2", 20e-9], ["p1", 10e-9]]


@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 + 5, 2 ** 33])
def test_seeded_inputs_are_rigid_and_repeat(seed):
    sphere = _load("geometry", "fibonacci_sphere")
    params = {"points": 500, "base_seed": 3}
    a = sphere.make(params, np.random.default_rng(seed))
    b = sphere.make(params, np.random.default_rng(seed))
    assert np.array_equal(a["positions"], b["positions"])
    R = a["pose"]
    assert np.allclose(R @ R.T, np.eye(3), atol=1e-12) and np.isclose(np.linalg.det(R), 1.0)
    base = sphere.lattice(500) @ sphere.rotation(np.random.default_rng(3)).T
    assert np.allclose(a["positions"], base @ R.T, atol=1e-12)
    # a rotation of the cube: exact signs and swaps of the base's coordinates
    assert set(np.abs(R).ravel()) == {0.0, 1.0}
    assert np.array_equal(np.sort(np.abs(a["positions"]).ravel()),
                          np.sort(np.abs(base).ravel()))
    assert np.allclose(np.linalg.norm(a["normals"], axis=1), 1.0)
    # the mesh is read as stored, whatever the seed
    knot = _load("geometry", "obj_file")
    k1 = knot.make({"file": "data/knot_dec.obj"}, np.random.default_rng(seed))
    v0, f0 = knot.read_obj(BENCH / "data" / "knot_dec.obj")
    assert np.array_equal(k1["vertices"], v0) and np.array_equal(k1["faces"], f0)
    assert f0.shape == (700, 3) and v0.shape == (1357, 3)


def test_the_guard_compares_top_level_names_whole():
    assert guard.forbidden_loaded(["shm3d_torch", "shm3d_torch.solve", "numpy"]) == []
    assert guard.forbidden_loaded(["shm3d.ops", "jax", "jaxlib.xla", "flax.linen",
                                   "jax_extra"]) == ["flax.linen", "jax", "jaxlib.xla",
                                                     "shm3d.ops"]


def test_no_file_of_the_benchmark_imports_jax_or_the_jax_package():
    files = bench_files("*.py")
    assert len(files) > 20
    for p in files:
        for mod in guard.imports_of(p):
            assert guard.top_level(mod) not in guard.FORBIDDEN, (p, mod)
    for p in [f for f in files if "reference" in f.relative_to(BENCH).parts]:
        for mod in guard.imports_of(p):
            assert guard.top_level(mod) != guard.PROGRAM, (p, mod)
