"""``GET /dashboard`` — a single self-contained operational page.

The port's copy of heatmap_tpu/serve/dashboard.py: the same bytes.
One HTML document, served by the stdlib HTTP shell with **no external
assets**: styles, scripts, and SVG are all inline, so the page works
from an air-gapped GPU host, over an SSH tunnel, or saved to disk next
to an incident bundle. The page polls the endpoints the server already
exposes — ``/healthz`` for status (SLO burn, brownout rung, fleet
ring, recent anomalies) and ``/series`` (obs/timeseries.py) for
history — and renders live sparklines for the headline series. On a
fleet router the same page fans out automatically: its ``/series``
requests carry ``fleet=1``, so each card folds every backend's
history.

Charting follows the repo's data-viz conventions: single-series
sparklines (the card title names the series — no legend), a
min/max band under a 2 px ``last``-value line, categorical slot-1
blue for series ink, reserved status colors (always icon + label,
never color alone) for health chips, recessive hairline grid, text in
ink tokens, dark mode as selected steps of the same palette (not an
automatic flip), and a per-card data table as the non-visual
fallback. Sampler off (``--telemetry-sample-interval 0``) degrades
gracefully: cards say so instead of erroring, and the status row
still works from ``/healthz`` alone.

No torch anywhere in this module — it is served from the same
process-light shell as serve/http.py.
"""

from __future__ import annotations

import json

#: Headline cards: ``name`` is the flattened telemetry series
#: (histograms read via their ``_sum``/``_count`` pair), ``mode`` how
#: the sampled buckets become a plotted value — ``rate`` (per-second
#: delta of a counter), ``mean`` (delta-sum over delta-count of a
#: histogram pair), ``level`` (the sampled gauge value), — and
#: ``agg`` how frames (label sets, fleet backends) fold into one line.
DEFAULT_HEADLINES = (
    {"title": "Requests / s", "name": "http_requests_total",
     "mode": "rate", "agg": "sum", "unit": "req/s"},
    {"title": "Request latency (mean)", "name": "serve_request_seconds",
     "mode": "mean", "agg": "mean", "unit": "s"},
    {"title": "Ingest lag (mean)", "name": "ingest_lag_seconds",
     "mode": "mean", "agg": "mean", "unit": "s"},
    {"title": "Tile cache bytes", "name": "tile_cache_bytes",
     "mode": "level", "agg": "sum", "unit": "B"},
    {"title": "Brownout rung", "name": "degrade_rung",
     "mode": "level", "agg": "max", "unit": ""},
    {"title": "Incident bundles", "name": "incidents_total",
     "mode": "rate", "agg": "sum", "unit": "/s"},
)


def render_page(headlines=DEFAULT_HEADLINES, refresh_s: float = 3.0,
                title: str = "heatmap-tpu ops") -> bytes:
    """Build the dashboard document (bytes, utf-8 HTML)."""
    config = {"headlines": list(headlines), "refresh_s": float(refresh_s),
              "title": title}
    doc = _PAGE.replace("__CONFIG_JSON__", json.dumps(config))
    doc = doc.replace("__TITLE__", title)
    return doc.encode("utf-8")


_PAGE = """<!DOCTYPE html>
<html lang="en">
<head>
<meta charset="utf-8">
<meta name="viewport" content="width=device-width, initial-scale=1">
<title>__TITLE__</title>
<style>
  .viz-root {
    color-scheme: light;
    --surface-1: #fcfcfb; --page: #f9f9f7;
    --ink-1: #0b0b0b; --ink-2: #52514e; --muted: #898781;
    --grid: #e1e0d9; --baseline: #c3c2b7;
    --border: rgba(11,11,11,0.10);
    --series-1: #2a78d6; --series-band: rgba(42,120,214,0.16);
    --status-good: #0ca30c; --status-warning: #fab219;
    --status-serious: #ec835a; --status-critical: #d03b3b;
  }
  @media (prefers-color-scheme: dark) {
    :root:where(:not([data-theme="light"])) .viz-root {
      color-scheme: dark;
      --surface-1: #1a1a19; --page: #0d0d0d;
      --ink-1: #ffffff; --ink-2: #c3c2b7; --muted: #898781;
      --grid: #2c2c2a; --baseline: #383835;
      --border: rgba(255,255,255,0.10);
      --series-1: #3987e5; --series-band: rgba(57,135,229,0.22);
    }
  }
  :root[data-theme="dark"] .viz-root {
    color-scheme: dark;
    --surface-1: #1a1a19; --page: #0d0d0d;
    --ink-1: #ffffff; --ink-2: #c3c2b7; --muted: #898781;
    --grid: #2c2c2a; --baseline: #383835;
    --border: rgba(255,255,255,0.10);
    --series-1: #3987e5; --series-band: rgba(57,135,229,0.22);
  }
  body.viz-root {
    margin: 0; background: var(--page); color: var(--ink-1);
    font: 14px/1.45 system-ui, -apple-system, "Segoe UI", sans-serif;
  }
  header { padding: 14px 20px 6px; }
  header h1 { font-size: 17px; margin: 0 0 8px; font-weight: 650; }
  #chips { display: flex; flex-wrap: wrap; gap: 8px; }
  .chip {
    display: inline-flex; align-items: center; gap: 6px;
    background: var(--surface-1); border: 1px solid var(--border);
    border-radius: 999px; padding: 3px 11px; color: var(--ink-2);
    font-size: 12.5px;
  }
  .chip .dot { font-weight: 700; }
  .chip.good .dot { color: var(--status-good); }
  .chip.warning .dot { color: var(--status-warning); }
  .chip.serious .dot { color: var(--status-serious); }
  .chip.critical .dot { color: var(--status-critical); }
  main {
    display: grid; gap: 14px; padding: 12px 20px 24px;
    grid-template-columns: repeat(auto-fill, minmax(280px, 1fr));
  }
  .card {
    background: var(--surface-1); border: 1px solid var(--border);
    border-radius: 8px; padding: 12px 14px 8px; position: relative;
  }
  .card h2 { font-size: 12.5px; font-weight: 600; color: var(--ink-2);
             margin: 0; }
  .card .value { font-size: 22px; font-weight: 650; margin: 2px 0 4px; }
  .card .value .unit { font-size: 12px; color: var(--muted);
                       font-weight: 500; margin-left: 4px; }
  .card svg { display: block; width: 100%; height: 64px; }
  .card .meta { color: var(--muted); font-size: 11.5px; margin: 4px 0; }
  .card details { margin: 2px 0 4px; }
  .card summary { color: var(--muted); font-size: 11.5px;
                  cursor: pointer; }
  .card table { width: 100%; border-collapse: collapse; font-size: 11.5px;
                color: var(--ink-2);
                font-variant-numeric: tabular-nums; }
  .card td, .card th { text-align: right; padding: 1px 4px;
                       border-top: 1px solid var(--grid); }
  .card th { color: var(--muted); font-weight: 500; }
  #lists { display: grid; gap: 14px; padding: 0 20px 28px;
           grid-template-columns: repeat(auto-fill, minmax(340px, 1fr)); }
  .panel { background: var(--surface-1); border: 1px solid var(--border);
           border-radius: 8px; padding: 12px 14px; }
  .panel h2 { font-size: 12.5px; font-weight: 600; color: var(--ink-2);
              margin: 0 0 6px; }
  .panel ul { margin: 0; padding: 0; list-style: none; font-size: 12.5px; }
  .panel li { padding: 3px 0; border-top: 1px solid var(--grid);
              color: var(--ink-2); }
  .panel li:first-child { border-top: 0; }
  .panel .empty { color: var(--muted); }
  #tooltip {
    position: fixed; pointer-events: none; display: none; z-index: 10;
    background: var(--surface-1); border: 1px solid var(--border);
    border-radius: 6px; padding: 4px 8px; font-size: 11.5px;
    color: var(--ink-1); box-shadow: 0 2px 8px rgba(0,0,0,0.18);
    font-variant-numeric: tabular-nums;
  }
  #foot { color: var(--muted); font-size: 11.5px; padding: 0 20px 18px; }
</style>
</head>
<body class="viz-root">
<header>
  <h1>__TITLE__</h1>
  <div id="chips"><span class="chip"><span class="dot">·</span>
    loading…</span></div>
</header>
<main id="cards"></main>
<div id="lists">
  <div class="panel"><h2>SLO burn</h2><ul id="slo-list">
    <li class="empty">no SLO engine installed</li></ul></div>
  <div class="panel"><h2>Recent anomalies</h2><ul id="anomaly-list">
    <li class="empty">none</li></ul></div>
  <div class="panel"><h2>Fleet</h2><ul id="fleet-list">
    <li class="empty">single process</li></ul></div>
</div>
<div id="foot"></div>
<div id="tooltip"></div>
<script>
"use strict";
const CONFIG = __CONFIG_JSON__;
const tooltip = document.getElementById("tooltip");

function fmt(v, unit) {
  if (v === null || v === undefined || !isFinite(v)) return "–";
  const a = Math.abs(v);
  let s;
  if (a >= 1e9) s = (v / 1e9).toFixed(2) + "G";
  else if (a >= 1e6) s = (v / 1e6).toFixed(2) + "M";
  else if (a >= 1e4) s = (v / 1e3).toFixed(1) + "k";
  else if (a >= 100) s = v.toFixed(0);
  else if (a >= 1) s = v.toFixed(2);
  else if (a === 0) s = "0";
  else s = v.toPrecision(2);
  return unit ? s + " " + unit : s;
}
function clock(ts) {
  return new Date(ts * 1000).toTimeString().slice(0, 8);
}

// points: [ts, min, max, sum, count, last] per bucket (obs/timeseries).
function toValues(points, step, mode) {
  const out = [];
  if (mode === "rate") {
    for (let i = 1; i < points.length; i++) {
      const dt = points[i][0] - points[i - 1][0];
      if (dt <= 0) continue;
      const dv = points[i][5] - points[i - 1][5];
      out.push({ts: points[i][0], v: Math.max(0, dv / dt),
                lo: null, hi: null});
    }
  } else {
    for (const p of points)
      out.push({ts: p[0], v: p[5], lo: p[1], hi: p[2]});
  }
  return out;
}
// Histogram mean: pair the _sum/_count series bucket-by-bucket.
function meanValues(sumPts, countPts) {
  const counts = new Map(countPts.map(p => [p[0], p[5]]));
  const raw = [];
  for (const p of sumPts) {
    const c = counts.get(p[0]);
    if (c !== undefined) raw.push([p[0], p[5], c]);
  }
  const out = [];
  for (let i = 1; i < raw.length; i++) {
    const dc = raw[i][2] - raw[i - 1][2];
    if (dc <= 0) continue;
    out.push({ts: raw[i][0], v: (raw[i][1] - raw[i - 1][1]) / dc,
              lo: null, hi: null});
  }
  return out;
}
function foldFrames(perFrame, agg) {
  const byTs = new Map();
  for (const vals of perFrame)
    for (const p of vals) {
      const cur = byTs.get(p.ts);
      if (!cur) byTs.set(p.ts, {ts: p.ts, v: p.v, lo: p.lo, hi: p.hi, n: 1});
      else {
        cur.n += 1;
        if (agg === "max") cur.v = Math.max(cur.v, p.v);
        else cur.v += p.v;
        if (p.lo !== null) cur.lo = cur.lo === null ? p.lo
            : Math.min(cur.lo, p.lo);
        if (p.hi !== null) cur.hi = cur.hi === null ? p.hi
            : Math.max(cur.hi, p.hi);
      }
    }
  const out = [...byTs.values()].sort((a, b) => a.ts - b.ts);
  if (agg === "mean") for (const p of out) p.v /= p.n;
  return out;
}

function sparkline(el, vals, unit, step) {
  const W = 300, H = 64, PAD = 4;
  if (!vals.length) {
    el.innerHTML = '<text x="8" y="36" fill="var(--muted)" ' +
      'font-size="12">no data (sampler off?)</text>';
    return;
  }
  let lo = Infinity, hi = -Infinity;
  for (const p of vals) {
    lo = Math.min(lo, p.lo !== null && p.lo !== undefined ? p.lo : p.v);
    hi = Math.max(hi, p.hi !== null && p.hi !== undefined ? p.hi : p.v);
  }
  if (hi === lo) { hi += 1; lo -= lo === 0 ? 0 : 1; }
  const t0 = vals[0].ts, t1 = vals[vals.length - 1].ts || t0 + 1;
  const x = ts => t1 === t0 ? PAD
      : PAD + (W - 2 * PAD) * (ts - t0) / (t1 - t0);
  const y = v => H - PAD - (H - 2 * PAD) * (v - lo) / (hi - lo);
  let band = "";
  if (vals.some(p => p.lo !== null && p.lo !== undefined)) {
    const top = vals.map(p => x(p.ts).toFixed(1) + "," +
        y(p.hi === null ? p.v : p.hi).toFixed(1));
    const bot = [...vals].reverse().map(p => x(p.ts).toFixed(1) + "," +
        y(p.lo === null ? p.v : p.lo).toFixed(1));
    band = '<polygon points="' + top.concat(bot).join(" ") +
        '" fill="var(--series-band)" stroke="none"/>';
  }
  const line = vals.map(p => x(p.ts).toFixed(1) + "," +
      y(p.v).toFixed(1)).join(" ");
  const last = vals[vals.length - 1];
  el.setAttribute("viewBox", "0 0 " + W + " " + H);
  el.innerHTML =
    '<line x1="0" y1="' + (H - PAD) + '" x2="' + W + '" y2="' +
    (H - PAD) + '" stroke="var(--baseline)" stroke-width="1"/>' + band +
    '<polyline points="' + line + '" fill="none" ' +
    'stroke="var(--series-1)" stroke-width="2" stroke-linejoin="round" ' +
    'stroke-linecap="round"/>' +
    '<circle cx="' + x(last.ts).toFixed(1) + '" cy="' +
    y(last.v).toFixed(1) + '" r="3" fill="var(--series-1)"/>';
  el.onmousemove = ev => {
    const rect = el.getBoundingClientRect();
    const fx = (ev.clientX - rect.left) / rect.width * W;
    let best = vals[0], d = Infinity;
    for (const p of vals) {
      const dd = Math.abs(x(p.ts) - fx);
      if (dd < d) { d = dd; best = p; }
    }
    tooltip.style.display = "block";
    tooltip.style.left = (ev.clientX + 12) + "px";
    tooltip.style.top = (ev.clientY + 12) + "px";
    tooltip.textContent = clock(best.ts) + "  " + fmt(best.v, unit) +
        (best.lo !== null && best.lo !== undefined
         ? "  (min " + fmt(best.lo, "") + " / max " + fmt(best.hi, "") + ")"
         : "");
  };
  el.onmouseleave = () => { tooltip.style.display = "none"; };
}

async function getJSON(url) {
  const resp = await fetch(url, {cache: "no-store"});
  if (!resp.ok) throw new Error(url + " -> " + resp.status);
  return resp.json();
}
async function series(name) {
  const doc = await getJSON("/series?fleet=1&name=" +
      encodeURIComponent(name));
  return doc.frames || [];
}

function card(h) {
  const div = document.createElement("div");
  div.className = "card";
  div.innerHTML = '<h2></h2><div class="value">–</div>' +
    '<svg role="img"></svg><div class="meta">–</div>' +
    '<details><summary>data</summary><table></table></details>';
  div.querySelector("h2").textContent = h.title;
  div.querySelector("svg").setAttribute("aria-label", h.title);
  document.getElementById("cards").appendChild(div);
  return div;
}

async function refreshCard(h, el) {
  let vals = [], step = null, tier = null;
  try {
    if (h.mode === "mean") {
      const sums = await series(h.name + "_sum");
      const counts = await series(h.name + "_count");
      const byKey = new Map(counts.map(f => [
        (f.backend || "") + "|" + f.key, f]));
      const perFrame = [];
      for (const f of sums) {
        const cf = byKey.get((f.backend || "") + "|" +
            f.key.replace("_sum", "_count"));
        if (cf) perFrame.push(meanValues(f.points, cf.points));
        if (step === null) { step = f.step; tier = f.tier; }
      }
      vals = foldFrames(perFrame, h.agg === "max" ? "max" : "mean");
    } else {
      const frames = await series(h.name);
      const perFrame = [];
      for (const f of frames) {
        perFrame.push(toValues(f.points, f.step, h.mode));
        if (step === null) { step = f.step; tier = f.tier; }
      }
      vals = foldFrames(perFrame, h.agg);
    }
  } catch (e) { vals = []; }
  const last = vals.length ? vals[vals.length - 1].v : null;
  el.querySelector(".value").innerHTML = "";
  el.querySelector(".value").append(fmt(last, ""));
  if (h.unit) {
    const u = document.createElement("span");
    u.className = "unit"; u.textContent = h.unit;
    el.querySelector(".value").appendChild(u);
  }
  sparkline(el.querySelector("svg"), vals, h.unit, step);
  el.querySelector(".meta").textContent = step === null
      ? "awaiting samples"
      : "resolution " + step + " s (tier " + tier + ") · " +
        vals.length + " buckets";
  const rows = vals.slice(-10).map(p => "<tr><td>" + clock(p.ts) +
      "</td><td>" + fmt(p.v, h.unit) + "</td></tr>").join("");
  el.querySelector("table").innerHTML =
    "<tr><th>time</th><th>value</th></tr>" + rows;
}

function chip(cls, icon, label) {
  return '<span class="chip ' + cls + '"><span class="dot">' + icon +
      '</span>' + label + '</span>';
}

function renderHealth(h) {
  const chips = [];
  const status = h.status || "unknown";
  chips.push(status === "ok"
      ? chip("good", "\\u2713", "serving ok")
      : chip("serious", "\\u26a0", "status: " + status));
  const slo = h.slo;
  if (slo) {
    const breaching = slo.breaching || [];
    chips.push(breaching.length
        ? chip("critical", "\\u2715", "SLO breach: " + breaching.join(", "))
        : chip("good", "\\u2713", "SLO ok"));
  }
  const degrade = h.degrade;
  if (degrade && degrade.rung !== undefined) {
    const r = degrade.rung;
    chips.push(chip(r === 0 ? "good" : (r >= 3 ? "critical" : "warning"),
        r === 0 ? "\\u2713" : "\\u26a0", "brownout rung " + r));
  }
  const anomalies = h.anomalies || [];
  chips.push(anomalies.length
      ? chip("warning", "\\u26a0", anomalies.length + " recent anomalies")
      : chip("good", "\\u2713", "no anomalies"));
  const fleet = h.fleet;
  if (fleet && fleet.backends) {
    const n = Object.keys(fleet.backends).length;
    const up = (fleet.eligible || []).length;
    chips.push(chip(up === n ? "good" : (up ? "warning" : "critical"),
        up === n ? "\\u2713" : "\\u26a0",
        "fleet " + up + "/" + n + " eligible"));
  }
  const tstats = h.telemetry;
  if (tstats) chips.push(chip("good", "\\u00b7", tstats.series +
      " series · " + tstats.points + " pts"));
  document.getElementById("chips").innerHTML = chips.join("");

  const sloList = document.getElementById("slo-list");
  if (slo && slo.objectives && Object.keys(slo.objectives).length) {
    sloList.innerHTML = Object.entries(slo.objectives).map(([name, o]) => {
      const burn = (h.slo_burn || {})[name];
      return "<li>" + name + " — burn " +
          (burn === undefined ? "–" : fmt(burn, "")) +
          (o.breaching ? " \\u2715 breaching" : "") + "</li>";
    }).join("");
  }
  const aList = document.getElementById("anomaly-list");
  if (anomalies.length) {
    aList.innerHTML = anomalies.slice().reverse().map(a =>
      "<li>" + clock(a.ts) + " " + a.series + " z=" + a.z +
      " (threshold " + a.threshold + ")</li>").join("");
  } else {
    aList.innerHTML = '<li class="empty">none</li>';
  }
  const fList = document.getElementById("fleet-list");
  if (fleet && fleet.backends) {
    fList.innerHTML = Object.entries(fleet.backends).map(([bid, b]) =>
      "<li>" + bid + " — " + (b.breaker || b.state || "?") +
      ((fleet.eligible || []).includes(bid) ? "" : " (out of ring)") +
      "</li>").join("");
  }
}

const cards = CONFIG.headlines.map(h => [h, card(h)]);
let ticking = false;
async function tick() {
  if (ticking) return;
  ticking = true;
  try {
    try { renderHealth(await getJSON("/healthz")); } catch (e) {}
    await Promise.all(cards.map(([h, el]) => refreshCard(h, el)));
    document.getElementById("foot").textContent =
      "refreshed " + new Date().toTimeString().slice(0, 8) +
      " · every " + CONFIG.refresh_s + " s · /series · /healthz · " +
      "/metrics";
  } finally { ticking = false; }
}
tick();
setInterval(tick, CONFIG.refresh_s * 1000);
</script>
</body>
</html>
"""
