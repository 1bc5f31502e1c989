"""Runs of the harness on the CPU over the miniature pools of
benchmark/tests/data: a dummy cell and a dummy metric found from files
alone, the shape of the result, the comparison against the reference's
hashes with the timed path broken underneath, the control, the import
check and the refusal without a card."""
import dataclasses
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from conftest import BENCH, ROOT
from harness import compare, spec

DATA = os.path.join(BENCH, "tests", "data")
DUMMY_METRIC = '''"""Pictures returned in the window (a dummy metric)."""


def read(rec):
    return float(len(rec.pictures()))
'''


def _root(tmp_path, traffic_name="serial", settings=None):
    """A checkout that holds a dummy cell of each miniature configuration
    and a dummy metric, written as a later change would add them: files
    and BENCHMARK.json entries only."""
    root = tmp_path / "checkout"
    bench_dir = root / "benchmark"
    shutil.copytree(os.path.join(BENCH, "metrics"), bench_dir / "metrics")
    (bench_dir / "metrics" / "pictures_seen.py").write_text(DUMMY_METRIC)
    shutil.copytree(os.path.join(DATA, "pools"),
                    bench_dir / "tests" / "data" / "pools")
    (bench_dir / "configs").mkdir()
    (bench_dir / "traffic").mkdir()
    (bench_dir / "traffic" / f"{traffic_name}.json").write_text(json.dumps(
        {"settings": settings or {}}))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        b = json.load(f)
    real_cells = b["workloads"]
    b["configs"], b["workloads"] = [], []
    for name in ("tiny8_inter_cdef", "tiny10_grain_lr"):
        shutil.copy(os.path.join(DATA, "configs", f"{name}.json"),
                    bench_dir / "configs")
        b["configs"].append({"name": name, "source": "a miniature",
                             "file": f"benchmark/configs/{name}.json",
                             "reduced": [], "why": "CPU tests"})
        b["workloads"].append({"name": f"{name}.{traffic_name}",
                               "config": name, "traffic": traffic_name,
                               "chips": 1, "why": "CPU tests"})
    b["per_layer"].append({"name": "pictures_seen", "unit": "frames",
                           "better": "higher", "source": "host_clock",
                           "layer": "Decoder",
                           "moves": "fps"})
    # a metric listing cells reads in every dummy cell, but in a pipelined
    # one only where it reads in a pipelined cell of the benchmark
    ahead = {w["name"] for w in real_cells if w["traffic"] == "ahead"}
    for m in b["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [w["name"] for w in b["workloads"]
                              if w["traffic"] != "ahead" or
                              ahead & set(m["workloads"])]
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    return str(root)


def _run(root, cell, trace=False, seconds=1.0, seed=2 ** 31 + 3):
    import run
    return run.run_cell(root, spec.load_cell(root, cell), seed, seconds,
                        trace, device="cpu")


def test_dummy_cell_and_metric_from_files(tmp_path):
    root = _root(tmp_path)
    result, _ = _run(root, "tiny8_inter_cdef.serial", trace=True)
    assert result["correct"] is True
    assert result["metrics"]["pictures_seen"]["value"] >= 1
    assert result["metrics"]["pictures_seen"]["unit"] == "frames"


def test_result_shape(tmp_path):
    root = _root(tmp_path)
    result, limits = _run(root, "tiny8_inter_cdef.serial")
    assert list(result) == ["correct", "attempted", "failed", "metrics",
                            "device", "checks"]
    assert set(result["metrics"]) == {"fps", "setup_s"}
    for m in result["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= \
        set(result["device"])
    assert result["checks"] == {k: {"value": 0, "limit": 0}
                                for k in compare.LIMITS}
    assert limits == {k: (0, 0) for k in compare.LIMITS}
    assert result["attempted"] >= 1 and result["failed"] == 0
    json.dumps(result)


def test_traced_result_shape(tmp_path):
    root = _root(tmp_path)
    result, _ = _run(root, "tiny10_grain_lr.serial", trace=True)
    assert result["correct"] is True
    assert list(result)[-1] == "checks"
    # stage spans and the decoder's clock; no device here, so no device
    # metric is reported rather than a 0
    for name in ("frame_p95_ms", "first_picture_ms", "plan_ms",
                 "filters_ms", "grain_ms"):
        assert result["metrics"][name]["value"] > 0, name
    for name in ("kernels_per_frame", "kernel_ms_per_frame",
                 "filters_roofline_pct", "device_idle_pct"):
        assert name not in result["metrics"]
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}


def test_pipelined_traffic(tmp_path):
    root = _root(tmp_path, "ahead", {"n_threads": 4, "max_frame_delay": 3})
    result, _ = _run(root, "tiny8_inter_cdef.ahead", trace=True,
                     seconds=2.0)
    assert result["correct"] is True
    assert result["metrics"]["stage_overlap"]["value"] > 0


def _broken(monkeypatch, fault):
    """Break what the decoder returns, underneath the harness."""
    from dav1d_mirror_tpu_torch import api
    orig = api.Decoder.get_picture
    state = {"n": 0, "first": None}

    def get_picture(self):
        pic = orig(self)
        if pic is None:
            return None
        state["n"] += 1
        if fault == "state unchanged":
            # every picture of a stream repeats the stream's first
            if pic.frame_hdr.frame_type == 0:
                state["first"] = pic.planes
            return dataclasses.replace(pic, planes=state["first"])
        if fault == "half left out" and state["n"] % 2 == 0:
            return orig(self)
        if fault == "answer altered" and state["n"] % 3 == 0:
            y = pic.planes[0].copy()
            y[3, 5] ^= 1
            return dataclasses.replace(pic, planes=(y,) + pic.planes[1:])
        return pic
    monkeypatch.setattr(api.Decoder, "get_picture", get_picture)


@pytest.mark.parametrize("fault,kind", [
    ("state unchanged", "wrong"),
    ("half left out", "missing"),
    ("answer altered", "wrong")])
def test_a_broken_decoder_is_not_correct(tmp_path, monkeypatch, capsys,
                                         fault, kind):
    root = _root(tmp_path)
    _broken(monkeypatch, fault)
    result, limits = _run(root, "tiny8_inter_cdef.serial", seconds=2.0)
    assert result["correct"] is False
    value, limit = limits["failed_pictures"]
    assert value > limit == 0 and result["failed"] == value
    err = capsys.readouterr().err
    wrong, missing = (int(err.split(f" {k}")[0].split()[-1])
                      for k in ("wrong", "missing"))
    assert {"wrong": wrong, "missing": missing}[kind] > 0


@pytest.mark.parametrize("cell", ["tiny8_inter_cdef.serial",
                                  "tiny10_grain_lr.serial"])
def test_the_control_is_not_correct(tmp_path, cell):
    from tools import control
    root = _root(tmp_path)
    c = control.control_cell(spec.load_cell(root, cell))
    rows = control.readings(c, [5, 2 ** 31 + 9], 1.0, "cpu", root)
    for _, nums, correct, _ in rows:
        assert not correct and nums["failed_pictures"] > 0


def test_grain_off_is_wrong_where_grain_is_due(tmp_path):
    root = _root(tmp_path)
    c = spec.load_cell(root, "tiny10_grain_lr.serial")
    c = dataclasses.replace(c, traffic={"settings": {"apply_grain": False}})
    import run
    result, _ = run.run_cell(root, c, 3, 1.0, False, "cpu")
    assert result["correct"] is True      # compared with the grain-free
    # reference: the same pictures judged as grained ones are wrong
    from harness import drive, pool as pool_mod
    from dav1d_mirror_tpu_torch import api
    pool = pool_mod.load_pool(root, c.config)
    dec = api.Decoder(api.Settings(device="cpu", apply_grain=False))
    st = drive.drive(dec, pool, iter([0, 1]), 1, 0.0)
    dec.close()
    assert compare.compare(st.visits, pool, "grain")["wrong_pictures"] > 0


def test_plane_md5_is_the_md5_muxers_bytes():
    y = np.arange(12, dtype=np.int32).reshape(3, 4)
    import hashlib
    assert compare.plane_md5(y, 8) == hashlib.md5(
        y.astype(np.uint8).tobytes()).hexdigest()
    assert compare.plane_md5(y, 10) == hashlib.md5(
        y.astype("<u2").tobytes()).hexdigest()


def test_import_check(monkeypatch):
    import dav1d_mirror_tpu_torch.api  # noqa: F401
    assert "dav1d_mirror_tpu" not in compare.forbidden_modules()
    monkeypatch.setitem(sys.modules, "dav1d_mirror_tpu.api", sys)
    assert "dav1d_mirror_tpu" in compare.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert "jax" in compare.forbidden_modules()


def test_a_run_loads_no_jax_nor_the_jax_package(tmp_path):
    """A whole CPU run in a fresh process: neither JAX, nor the JAX
    package, nor the pool writer (which imports it) is loaded."""
    root = _root(tmp_path)
    code = (
        "import sys; sys.path[:0] = [%r, %r]\n"
        "import run\n"
        "from harness import compare, spec\n"
        "r, _ = run.run_cell(%r, spec.load_cell(%r, "
        "'tiny10_grain_lr.serial'), 1, 1.0, True, 'cpu')\n"
        "assert r['correct']\n"
        "bad = compare.forbidden_modules() + [m for m in sys.modules "
        "if 'make_pools' in m]\n"
        "print(sorted(bad))\n" % (BENCH, ROOT, root, root))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=600, cwd=root,
                       env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.strip().splitlines()[-1] == "[]"


def test_without_a_card_no_result(tmp_path):
    """run.py exits non-zero and prints nothing on standard output where
    torch sees no CUDA device, and in a directory that holds only
    BENCHMARK.json and the benchmark's files (no program)."""
    bare = tmp_path / "bare"
    shutil.copytree(BENCH, bare / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), bare)
    for cwd in (ROOT, str(bare)):
        r = subprocess.run(
            [sys.executable, "benchmark/run.py", "--workload",
             "c2_1080p8.serial", "--seed", "1", "--seconds", "1",
             "--trace", "0"], cwd=cwd, capture_output=True, text=True,
            timeout=300, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
        assert r.returncode != 0 and r.stdout == "", cwd
