"""The port's card tooling on the CPU: ``_epoch`` (the kernel epoch),
``verify_partitioned_onchip``, ``sweep_partitioned`` and
``apply_decisions``, mirroring ``tests/test_onchip_tools.py``.

The epoch loads by path with the standard library alone and moves with
every listed file. The verify and sweep twins refuse the CPU (rc 2) and
raise without CUDA; the verify twin keeps the JAX tool's state, transient
and exit-code rules (held to the JAX functions themselves). The sweep
twin's rows run here on the plain versions (CUDA events and the
profiler stubbed) to hold its resume: measured configs are skipped, a
torn last line is ignored. ``apply_decisions`` on synthetic state gives
each verdict: applied, FLIP, blocked, insufficient-data and not
applicable. Each of the five twins with a command line takes its JAX
tool's flags and defaults (plus ``--device``)."""

import argparse
import importlib.util
import json
import os
import pathlib
import shutil
import subprocess
import sys

import pytest
import torch

from test_torch_tools import _jax_tool

from heatmap_tpu_torch.ops import histogram
from heatmap_tpu_torch.ops import pallas_kernels as pk
from heatmap_tpu_torch.tools import apply_decisions as dec
from heatmap_tpu_torch.tools import sweep_partitioned as sw
from heatmap_tpu_torch.tools import verify_partitioned_onchip as vp

ROOT = pathlib.Path(__file__).resolve().parents[1]
TOOLS = ROOT / "heatmap_tpu_torch" / "tools"


def _load_epoch(path):
    spec = importlib.util.spec_from_file_location("_epoch_copy", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ------------------------------------------------------------------ epoch

def test_epoch_loads_by_path_with_the_stdlib_alone():
    script = (
        "import importlib.util, json, sys\n"
        f"spec = importlib.util.spec_from_file_location('_epoch', "
        f"{str(TOOLS / '_epoch.py')!r})\n"
        "mod = importlib.util.module_from_spec(spec)\n"
        "spec.loader.exec_module(mod)\n"
        "e = mod.kernel_epoch()\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        "('torch', 'numpy', 'jax', 'heatmap_tpu', 'heatmap_tpu_torch'))\n"
        "print(json.dumps({'epoch': e, 'bad': bad}))\n")
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True,
                          text=True, timeout=60, cwd="/")
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout)
    assert out["bad"] == []
    assert len(out["epoch"]) == 10 and int(out["epoch"], 16) >= 0


def test_epoch_shared_between_tools():
    epoch = _load_epoch(TOOLS / "_epoch.py")
    assert vp.EPOCH == dec._verify_epoch() == epoch.kernel_epoch(
        extra_paths=(str(TOOLS / "verify_partitioned_onchip.py"),))
    assert vp.EPOCH != epoch.kernel_epoch()  # the verify twin hashes itself


@pytest.mark.parametrize("rel", _load_epoch(TOOLS / "_epoch.py").KERNEL_FILES)
def test_epoch_moves_with_each_listed_file(rel, tmp_path):
    src = ROOT / "heatmap_tpu_torch"
    mod = _load_epoch(TOOLS / "_epoch.py")
    copy = tmp_path / "heatmap_tpu_torch"
    for name in mod.KERNEL_FILES + ("tools/_epoch.py",):
        (copy / name).parent.mkdir(parents=True, exist_ok=True)
        shutil.copyfile(src / name, copy / name)
    cmod = _load_epoch(copy / "tools" / "_epoch.py")
    assert cmod.package_root() == str(copy)
    before = cmod.kernel_epoch()
    assert before == mod.kernel_epoch()
    with open(copy / rel, "ab") as f:
        f.write(b"\n")
    assert cmod.kernel_epoch() != before
    extra = tmp_path / "extra.py"
    extra.write_text("x = 1\n")
    with_extra = cmod.kernel_epoch(extra_paths=(str(extra),))
    extra.write_text("x = 2\n")
    assert cmod.kernel_epoch(extra_paths=(str(extra),)) != with_extra


# ----------------------------------------------------------------- verify

def test_verify_refuses_the_cpu_with_rc_2(capsys):
    assert vp.main(["--device", "cpu"]) == 2
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert lines[0] == {"kernel_epoch": vp.EPOCH}
    assert lines[1]["device"] == "cpu" and "refusing" in lines[1]["error"]


@pytest.mark.parametrize("tool", [vp, sw])
def test_card_tools_raise_without_cuda(tool, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        tool.main([])


def test_verify_rules_equal_jax():
    jv = _jax_tool("verify_partitioned_onchip")
    errors = [RuntimeError("UNAVAILABLE: worker crashed or restarted"),
              RuntimeError("DEADLINE_EXCEEDED: rpc"),
              ConnectionError("dropped"), TimeoutError("init"),
              ValueError("bad connection matrix in kernel layout"),
              RuntimeError("hm_window_bucketed_counts failed to launch: "
                           "cudaError 1")]
    for e in errors:
        assert vp._is_transient(e) == jv._is_transient(e), e
    for args in [(f, e, t) for f in (0, 1) for e in (0, 2) for t in (0, 3)]:
        assert vp._final_rc(*args) == jv._final_rc(*args), args
        assert vp._verdict(*args) == jv._verdict(*args), args


def test_verify_transient_skip_leaves_combo_unsettled(tmp_path):
    vp.TRANSIENT_SKIPS = 0
    state_path = str(tmp_path / "verify.jsonl")
    state = {}

    def boom():
        raise ConnectionError("card lost")

    try:
        assert vp._run_combo(state_path, state, "seg-x|{}", boom) is None
        assert vp.TRANSIENT_SKIPS == 1 and state == {}
        assert not os.path.exists(state_path)
        assert vp._final_rc(0, 0, vp.TRANSIENT_SKIPS) == 4
        assert vp._verdict(0, 0, vp.TRANSIENT_SKIPS) == "UNSETTLED"

        def det():
            raise RuntimeError("hm_segment_reduce_counts failed to launch: "
                               "cudaError 1")

        vp.TRANSIENT_SKIPS = 0
        assert vp._run_combo(state_path, state, "seg-y|{}", det) is None
        assert vp.TRANSIENT_SKIPS == 0
        assert state[f"{vp.EPOCH}|seg-y|{{}}"].startswith("error:")
        # Settled: re-runs skip it, unless --retry-errors.
        assert vp._settled(vp._load_state(state_path), "seg-y|{}")
        vp.RETRY_ERRORS = True
        assert not vp._settled(vp._load_state(state_path), "seg-y|{}")
    finally:
        vp.RETRY_ERRORS = False
        vp.TRANSIENT_SKIPS = 0
    assert vp._final_rc(0, 1, 0) == 3
    assert vp._final_rc(1, 1, 1) == 1


def test_verify_state_tolerates_a_torn_line_and_other_epochs(tmp_path):
    path = tmp_path / "verify.jsonl"
    path.write_text(json.dumps({f"{vp.EPOCH}|a|{{}}": True}) + "\n"
                    + json.dumps({"0000000000|b|{}": True}) + "\n"
                    + '{"torn')
    state = vp._load_state(str(path))
    assert vp._settled(state, "a|{}") and not vp._settled(state, "b|{}")
    assert vp._epoch_tally(state) == (1, 0, 0)
    # The next verdict starts a line of its own.
    vp._append_state(str(path), state, "c|{}", False)
    assert vp._epoch_tally(vp._load_state(str(path))) == (1, 1, 0)


@pytest.fixture
def plain_kernels(monkeypatch):
    """Run the twins' rows on the CPU: the private launchers take the
    plain version, the card's SM count is stubbed, CUDA events and the
    profiler do nothing."""

    class Event:
        def __init__(self, **kw):
            pass

        def record(self):
            pass

        def elapsed_time(self, other):
            return 1.0

    monkeypatch.setattr(vp, "launch_bucketed",
                        lambda r, c, w, wt, v, plan, item:
                        histogram._plain(r, c, w, wt, v))
    monkeypatch.setattr(vp, "launch_histogram",
                        lambda r, c, w, wt, v, plan:
                        histogram._plain(r, c, w, wt, v))
    monkeypatch.setattr(pk, "_sms", lambda index: 132)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "Event", Event)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(sw, "device_us", lambda fn, iters: 0.0)


def test_verify_cases_and_resume_on_plain_versions(plain_kernels, tmp_path,
                                                   monkeypatch, capsys):
    monkeypatch.setattr(vp, "N_POINTS", 1 << 12)
    monkeypatch.setattr(vp, "N_KEYS", 1 << 11)
    state_path = str(tmp_path / "verify.jsonl")
    assert vp.verify(torch.device("cpu"), state_path, {}) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()
             if x.startswith("{")]
    last = lines[-1]
    assert last["verdict"] == "BIT-EXACT" and last["failures"] == 0
    assert last["bit_exact"] == last["combos_done"] == 98
    seg = [x for x in lines if str(x.get("case", "")).startswith("seg-")]
    assert len(seg) == 15 and all(x["bit_exact"] for x in seg)
    # A re-run with the state settles everything and runs nothing.
    state = vp._load_state(state_path)
    assert vp.verify(torch.device("cpu"), state_path, state) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert len(lines) == 1 and lines[0]["combos_done"] == 98


def test_verify_plans_are_legal():
    from heatmap_tpu_torch.ops import partitioned as pt
    from heatmap_tpu_torch.ops.histogram import window_from_bounds

    win = window_from_bounds((44.0, 51.0), (-127.0, -117.0), zoom=15,
                             align_levels=12, pad_multiple=256)
    n = vp.N_POINTS
    default, item = vp.bucketed_plan(win, n)
    assert (default, item) == (pt.plan_counts(win, n), pt.ITEM_POINTS)
    plan, item = vp.bucketed_plan(win, n, chunks=4096, item_points=1024)
    assert plan.chunks * plan.per_chunk >= n and plan.per_chunk % 4 == 0
    assert plan.items_max == -(-n // 1024) + plan.buckets and item == 1024
    assert plan.chunks * plan.buckets <= pt.MAX_CHUNK_BASE
    assert vp.bucketed_plan(win, n, groups=4)[0].group_buckets == 256
    with pytest.raises(ValueError, match="GROUP_BUCKETS"):
        vp.bucketed_plan(pt.Window(15, 0, 0, 1 << 14, 1 << 14), n, groups=1)
    glob = vp.histogram_plan(win, n, 132, blocks=264)
    assert (glob.bands, glob.blocks) == (0, 264)
    hot = pt.Window(15, 0, 0, 256, 256)
    banded = vp.histogram_plan(hot, n, 132, walkers=8)
    assert banded.bands == 2 and banded.blocks == 16
    with pytest.raises(ValueError):
        vp.histogram_plan(win, n, 132, walkers=8)


# ------------------------------------------------------------------ sweep

def test_sweep_refuses_the_cpu_with_rc_2(capsys):
    assert sw.main(["--device", "cpu"]) == 2
    assert "refusing" in json.loads(capsys.readouterr().out)["error"]


def test_sweep_skips_measured_configs_and_a_torn_line(plain_kernels,
                                                      tmp_path, capsys):
    state = tmp_path / "sweep.jsonl"
    state.write_text(json.dumps({"config": "xla-scatter", "ms": 7.5})
                     + "\n" + json.dumps({"config": "partitioned",
                                          "ms": 2.5}) + "\n"
                     + '{"config": "bincount", "ms"')
    args = argparse.Namespace(n=10, steps=2, zoom=15, state=str(state))
    assert sw.sweep(torch.device("cpu"), args, sw._load_state(str(state))) \
        == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    by = {x["config"]: x for x in lines if "config" in x}
    assert by["xla-scatter"] == {"config": "xla-scatter", "ms": 7.5,
                                 "cached": True}
    assert by["partitioned"]["cached"] and "cached" not in by["bincount"]
    for name in ("partitioned weighted k=8", "xla-scatter weighted",
                 "cascade-pyramid16 scatter",
                 "cascade-pyramid16 partitioned", "sort-only stable=True",
                 "histogram global", "partitioned chunks=4096"):
        assert name in by and "error" not in by[name], name
    assert lines[-1]["errors"] == 0 and lines[-1]["device"] == "cpu"
    # The state gained the new rows (not the cached ones), whole lines.
    rows = sw._load_state(str(state))
    assert rows["xla-scatter"]["ms"] == 7.5 and "bincount" in rows
    assert sum(1 for x in state.read_text().splitlines()
               if '"xla-scatter"' in x) == 1


# -------------------------------------------------------- apply_decisions

def _write(path, rows):
    with open(path, "w") as f:
        for row in rows:
            f.write(json.dumps(row) + "\n")


def _decide(tmp_path, capsys, monkeypatch=None, defaults=None):
    if monkeypatch is not None:
        monkeypatch.setattr(dec, "_repo_defaults", lambda: defaults)
    assert dec.main(["--state-dir", str(tmp_path)]) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [x["decision"] for x in lines] == list(dec.DECISIONS)
    assert all(x["device"] == "host" for x in lines)
    return {x["decision"]: x for x in lines}


def test_decisions_keys_equal_jax(tmp_path, capsys, monkeypatch):
    jdec = _jax_tool("apply_decisions")
    by = _decide(tmp_path, capsys)
    monkeypatch.setattr(sys, "argv", ["apply_decisions", "--state-dir",
                                      str(tmp_path)])
    jdec.main()
    want = {x["decision"]: x for x in
            (json.loads(y) for y in capsys.readouterr().out.splitlines())}
    assert list(want) == list(by)
    for name, line in by.items():
        assert list(line) == [*want[name], "device"], name


def test_repo_defaults_resolve_as_on_a_card():
    assert dec._repo_defaults() == {"weighted_route": "partitioned",
                                    "bad_frac": 128,
                                    "cascade_backend": "partitioned"}


def test_insufficient_data_and_not_applicable(tmp_path, capsys):
    by = _decide(tmp_path, capsys)
    for name in ("weighted-routing", "cascade-backend", "stream-backend"):
        assert by[name]["verdict"] == "insufficient-data", by[name]
    assert by["bad-frac-default"]["verdict"].startswith(
        "not applicable on this card")
    assert by["bad-frac-default"]["repo_default"] == 128


def test_applied_flip_and_blocked(tmp_path, capsys, monkeypatch):
    _write(tmp_path / "sweep.jsonl", [
        {"config": "xla-scatter weighted", "ms": 4.0},
        {"config": "partitioned weighted k=8", "ms": 1.0},
        {"config": "cascade-pyramid16 scatter", "ms": 50.0},
        {"config": "cascade-pyramid16 partitioned", "ms": 10.0},
        {"config": "partitioned bc=65536 chunk=1024 bf=8 k=8", "ms": 2.0},
        {"config": "partitioned bc=65536 chunk=1024 bf=128 k=8", "ms": 1.0},
        {"check": "stream", "backend": "auto", "batch": 262144,
         "device": "cuda", "pts_per_s": 100e6},
        {"check": "stream", "backend": "partitioned", "batch": 262144,
         "device": "cuda", "pts_per_s": 150e6},
        {"check": "stream", "backend": "xla", "batch": 262144,
         "device": "cpu", "pts_per_s": 900e6},
    ])
    epoch = dec._verify_epoch()
    _write(tmp_path / "verify.jsonl", [
        {f"{epoch}|seg-clustered|{{}}": True},
        {f"{epoch}|seg-pileup|{{}}": True},
        {"0000000000|seg-unique|{}": False},  # another epoch: stale
    ])
    by = _decide(tmp_path, capsys)
    assert by["weighted-routing"]["verdict"].startswith("applied")
    assert by["weighted-routing"]["repo_default"] == "partitioned"
    assert by["cascade-backend"]["verdict"].startswith("applied")
    assert by["cascade-backend"]["seg_verify_count"] == 2
    # bad_frac stays "not applicable" whatever rows say.
    assert by["bad-frac-default"]["verdict"].startswith("not applicable")
    assert by["bad-frac-default"]["k8_bf128_ms"] == 1.0
    assert by["stream-backend"]["verdict"] == "FLIP (StreamConfig.backend " \
        "-> 'partitioned')"
    assert by["stream-backend"]["onchip_rows"] == 2  # CPU rows don't count
    # With other defaults the same evidence flips them.
    by = _decide(tmp_path, capsys, monkeypatch, None)
    assert by["weighted-routing"]["verdict"].startswith("FLIP")
    assert by["cascade-backend"]["verdict"].startswith("FLIP")
    # A failed seg-* verdict of this epoch blocks the cascade flip.
    with open(tmp_path / "verify.jsonl", "a") as f:
        f.write(json.dumps({f"{epoch}|seg-unique|{{}}": False}) + "\n")
    by = _decide(tmp_path, capsys)
    assert by["cascade-backend"]["verdict"].startswith("blocked")
    (tmp_path / "verify.jsonl").unlink()
    by = _decide(tmp_path, capsys)
    assert by["cascade-backend"]["verdict"] == \
        "blocked: no seg-* verify results"


def test_apply_decisions_needs_no_card(tmp_path, capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    by = _decide(tmp_path, capsys)
    assert by["cascade-backend"]["repo_default"] == "partitioned"


# ------------------------------------------------------------------ flags

class _Parsed(Exception):
    pass


def _flags(main, monkeypatch, *args):
    """{dest: default} of the parser ``main`` builds (stopped at its
    parse)."""
    def stop(self, *a, **k):
        raise _Parsed({x.dest: x.default for x in self._actions
                       if x.dest != "help"})

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", stop)
    with pytest.raises(_Parsed) as got:
        main(*args)
    monkeypatch.undo()
    return got.value.args[0]


@pytest.mark.parametrize("name", ["chaos_soak", "multiproc_check",
                                  "verify_partitioned_onchip",
                                  "sweep_partitioned", "apply_decisions"])
def test_flags_and_defaults_equal_jax(name, monkeypatch):
    import importlib

    twin = importlib.import_module(f"heatmap_tpu_torch.tools.{name}")
    got = _flags(twin.main, monkeypatch, [])
    want = _flags(_jax_tool(name).main, monkeypatch)
    if name == "apply_decisions":
        # The port's state lives apart from the JAX tools' onchip_state/.
        assert want.pop("state_dir") == "onchip_state"
        assert got.pop("state_dir") == "build/torch_onchip_state"
    else:
        assert got.pop("device") == "cuda"
    assert got == want
