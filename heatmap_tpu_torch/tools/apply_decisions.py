"""Evaluate the measurement-gated decisions against the evidence from
the card.

The port's twin of ``tools/apply_decisions.py``. Reads
``sweep.jsonl`` (``sweep_partitioned``'s rows, and ``stream`` rows in
the JAX ``tools/bench_stream.py`` shape) and ``verify.jsonl``
(``verify_partitioned_onchip``'s verdicts) from ``--state-dir`` and
prints one JSON line per decision with the JAX tool's keys:
``weighted-routing``, ``cascade-backend``, ``bad-frac-default`` and
``stream-backend``. Read-only: a flip stays a deliberate commit.

The repo's defaults are the port's, read as they resolve on a card
(``histogram._pick_backend`` for a weighted large window,
``BatchJobConfig().resolved_cascade_backend``); reading them needs no
card. A JAX knob that shapes only the TPU formulation gets the verdict
"not applicable on this card" with the reason (``bad_frac``: the
bucketed kernels have no scatter tail). The work is the host's, so each
line carries ``device`` "host".

    python -m heatmap_tpu_torch.tools.apply_decisions
        [--state-dir build/torch_onchip_state]
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys

from heatmap_tpu_torch.tools._common import HOST_FIELDS

#: Where the card tools keep their state (never ``onchip_state/``, which
#: belongs to the JAX tools).
DEFAULT_STATE_DIR = os.path.join("build", "torch_onchip_state")

DECISIONS = ("weighted-routing", "cascade-backend", "bad-frac-default",
             "stream-backend")

#: Why ``bad_frac`` has no decision here.
BAD_FRAC_REASON = (
    "bad_frac caps the TPU formulation's scatter tail of chunks that "
    "straddle blocks; the bucketed CUDA kernels group every point by "
    "sub-block and have no tail, so it is only validated "
    "(heatmap_tpu_torch/ops/partitioned.py)")


def _verify_epoch():
    """The current kernel epoch as the verify twin computes it (its
    ``_epoch.py`` over the kernel sources, plus the verify twin itself):
    seg-* verdicts of any other epoch are stale and gate nothing."""
    d = os.path.dirname(os.path.abspath(__file__))
    spec = importlib.util.spec_from_file_location(
        "_epoch", os.path.join(d, "_epoch.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.kernel_epoch(
        extra_paths=(os.path.join(d, "verify_partitioned_onchip.py"),))


def _repo_defaults():
    """What the port ships for each decided knob, as it resolves on a
    card, so a measured winner that is already the default reads
    "applied". None when the package will not import here."""
    try:
        import inspect

        from heatmap_tpu_torch.ops import histogram, partitioned
        from heatmap_tpu_torch.pipeline.batch import BatchJobConfig

        # A window above PALLAS_AUTO_MAX_CELLS, resolved for a card (the
        # device type alone decides; no card is needed to read it).
        big = histogram.Window(zoom=15, row0=0, col0=0, height=1024,
                               width=1280)
        sig = inspect.signature(partitioned.bin_rowcol_window_partitioned)
        return {
            "weighted_route": histogram._pick_backend("auto", big, "cuda"),
            "bad_frac": sig.parameters["bad_frac"].default,
            "cascade_backend":
                BatchJobConfig().resolved_cascade_backend("cuda"),
        }
    except Exception:  # noqa: BLE001 (introspection is best effort)
        return None


def _load_jsonl(path):
    out = {}
    try:
        with open(path) as f:
            for line in f:
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    continue
                if "config" in rec:  # sweep rows
                    out[rec["config"]] = rec
                elif rec.get("check") == "stream":  # stream rows
                    key = (f"stream {rec.get('backend')} "
                           f"b={rec.get('batch')} {rec.get('device')}")
                    out[key] = rec
                else:  # verify rows: {key: verdict}
                    out.update(rec)
    except OSError:
        pass
    return out


def decide(sweep: dict, verify: dict, defaults) -> list:
    """The four decision records from the loaded state."""

    def ms(name):
        rec = sweep.get(name)
        return rec.get("ms") if rec else None

    decisions = []

    # (a) Weighted large windows route to the bucketed kernel only if it
    # beats the weighted scatter.
    w_scatter = ms("xla-scatter weighted")
    w_part8 = ms("partitioned weighted k=8")
    if w_scatter is None or w_part8 is None:
        verdict = "insufficient-data"
    elif w_part8 < w_scatter:
        if defaults and defaults["weighted_route"] == "partitioned":
            verdict = ("applied (_pick_backend routes weighted large "
                       "windows to partitioned)")
        else:
            verdict = ("FLIP (_pick_backend: route weighted large "
                       "windows to partitioned)")
    else:
        verdict = "keep scatter"
    decisions.append({
        "decision": "weighted-routing",
        "verdict": verdict,
        "weighted_scatter_ms": w_scatter,
        "weighted_partitioned_k8_ms": w_part8,
        "repo_default": defaults["weighted_route"] if defaults else None,
    })

    # (b) Count jobs' cascade runs the segment-reduce kernel only if the
    # pyramid16 A/B wins AND the seg-* verify cases are bit-exact under
    # the current epoch.
    epoch = _verify_epoch()
    seg_keys = [k for k in verify if k.startswith(f"{epoch}|seg-")]
    seg_ok = bool(seg_keys) and all(verify[k] is True for k in seg_keys)
    c_scatter = ms("cascade-pyramid16 scatter")
    candidates = {
        "partitioned": ms("cascade-pyramid16 partitioned"),
        "partitioned k=4": ms("cascade-pyramid16 partitioned k=4"),
    }
    best_name, best_ms = None, None
    for name, val in candidates.items():
        if val is not None and (best_ms is None or val < best_ms):
            best_name, best_ms = name, val
    if c_scatter is None or best_ms is None:
        verdict = "insufficient-data"
    elif not seg_ok:
        verdict = ("blocked: seg-* verify cases not all bit-exact"
                   if seg_keys else "blocked: no seg-* verify results")
    elif best_ms < c_scatter:
        if (defaults and defaults["cascade_backend"] == "partitioned"
                and best_name.startswith("partitioned")):
            verdict = ("applied (count jobs resolve cascade_backend to "
                       f"'partitioned'; measured best: '{best_name}')")
        else:
            verdict = (f"FLIP (BatchJobConfig.cascade_backend -> "
                       f"'{best_name}' for count jobs)")
    else:
        verdict = "keep scatter"
    decisions.append({
        "decision": "cascade-backend",
        "verdict": verdict,
        "pyramid16_scatter_ms": c_scatter,
        "pyramid16_partitioned_ms": candidates["partitioned"],
        "pyramid16_partitioned_k4_ms": candidates["partitioned k=4"],
        "seg_verify_count": len(seg_keys),
        "seg_verify_all_ok": seg_ok,
        "seg_verify_epoch": epoch,
        "repo_default": defaults["cascade_backend"] if defaults else None,
    })

    # (c) bad_frac shapes only the TPU formulation: no verdict to draw.
    decisions.append({
        "decision": "bad-frac-default",
        "verdict": f"not applicable on this card: {BAD_FRAC_REASON}",
        "k8_bf8_ms": ms("partitioned bc=65536 chunk=1024 bf=8 k=8"),
        "k8_bf32_ms": ms("partitioned bc=65536 chunk=1024 bf=32 k=8"),
        "k8_bf128_ms": ms("partitioned bc=65536 chunk=1024 bf=128 k=8"),
        "repo_default": defaults["bad_frac"] if defaults else None,
    })

    # (d) StreamConfig.backend stays "auto" unless a pinned backend beats
    # the auto-routed pick by more than 10% on the card.
    stream_rows = {
        k: v for k, v in sweep.items()
        if k.startswith("stream ") and v.get("device") not in ("cpu",
                                                               "host")
        and "error" not in v
    }
    auto_rows = [v for k, v in stream_rows.items()
                 if k.startswith("stream auto ")]
    pinned = [(k, v) for k, v in stream_rows.items()
              if not k.startswith("stream auto ")]
    if not auto_rows or not pinned:
        verdict = "insufficient-data"
        best_pin, auto_pts = None, None
    else:
        auto_pts = max(v["pts_per_s"] for v in auto_rows)
        best_pin = max(pinned, key=lambda kv: kv[1]["pts_per_s"])
        if best_pin[1]["pts_per_s"] > 1.10 * auto_pts:
            verdict = (f"FLIP (StreamConfig.backend -> "
                       f"{best_pin[1]['backend']!r})")
        else:
            verdict = "keep auto"
    decisions.append({
        "decision": "stream-backend",
        "verdict": verdict,
        "auto_pts_per_s": auto_pts,
        "best_pinned": best_pin[0] if best_pin else None,
        "best_pinned_pts_per_s": best_pin[1]["pts_per_s"] if best_pin
        else None,
        "onchip_rows": len(stream_rows),
    })
    return [{**rec, **HOST_FIELDS} for rec in decisions]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="heatmap_tpu_torch.tools.apply_decisions")
    ap.add_argument("--state-dir", default=DEFAULT_STATE_DIR)
    args = ap.parse_args(argv)
    sweep = _load_jsonl(os.path.join(args.state_dir, "sweep.jsonl"))
    verify = _load_jsonl(os.path.join(args.state_dir, "verify.jsonl"))
    for rec in decide(sweep, verify, _repo_defaults()):
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
