"""Self-contained HTML run report.

The port's own copy of ``gpuschedule_tpu/obs/report.py``; its HTML equals
that package's to the byte (``tests/test_torch_obs.py``).

Renders one :class:`~gpuschedule_tpu_torch.obs.analyze.RunAnalysis` as a single
HTML file with **inline CSS/SVG only — zero network fetches, zero
dependencies**: open it from disk on an air-gapped box and everything is
there.  Panels:

- a KPI row (finished jobs, avg JCT, p99 wait, mean occupancy, useful
  goodput share);
- chip-occupancy and pending-queue time series (two stacked single-series
  charts sharing a time axis — never a dual-axis chart);
- wait/JCT CDFs with exact quantiles;
- the fault panel: goodput decomposition as a part-to-whole stacked bar
  plus the per-kind attribution table (hidden for fault-free runs);
- table views of every chart's data (distributions, slowest jobs), so no
  value is reachable only through color.

Charts follow the dataviz reference palette (validated ordering; series
identity always has a non-color channel: direct labels, legends, and the
table views).  Light and dark mode are both selected via CSS custom
properties — the dark values are their own steps, not an automatic flip.
Per-mark hover carries exact values via native SVG ``<title>`` tooltips.
"""

from __future__ import annotations

import heapq
import html
import math
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

from gpuschedule_tpu_torch.obs.analyze import RunAnalysis

# Plot geometry (CSS pixels inside the SVG viewBox).
_W, _H = 860, 220
_ML, _MR, _MT, _MB = 56, 16, 14, 30
_MAX_PTS = 400  # series are decimated to this many points before drawing


# --------------------------------------------------------------------- #
# formatting

def _fmt_dur(s: Optional[float]) -> str:
    if s is None:
        return "–"
    if s != s:
        return "nan"
    if s < 120:
        return f"{s:.0f} s"
    if s < 2 * 3600:
        return f"{s / 60:.1f} min"
    if s < 48 * 3600:
        return f"{s / 3600:.1f} h"
    return f"{s / 86400:.1f} d"


def _fmt_num(v: Optional[float]) -> str:
    if v is None:
        return "–"
    if v != v:
        return "nan"
    a = abs(v)
    if a >= 1e9:
        return f"{v / 1e9:.1f}B"
    if a >= 1e6:
        return f"{v / 1e6:.1f}M"
    if a >= 1e4:
        return f"{v / 1e3:.1f}K"
    if a >= 100 or v == int(v):
        return f"{v:,.0f}"
    return f"{v:.2f}"


def _fmt_pct(v: Optional[float]) -> str:
    return "–" if v is None else f"{100.0 * v:.1f}%"


def _esc(s: object) -> str:
    return html.escape(str(s), quote=True)


def _nice_ticks(lo: float, hi: float, n: int = 5) -> List[float]:
    """Round tick positions covering [lo, hi] (1/2/5 ladder)."""
    if hi <= lo:
        return [lo]
    raw = (hi - lo) / max(1, n)
    mag = 10 ** math.floor(math.log10(raw))
    step = next(
        (m * mag for m in (1, 2, 5, 10) if m * mag >= raw), 10 * mag
    )
    t = math.ceil(lo / step) * step
    out = []
    while t <= hi + 1e-9 * step:
        out.append(t)
        t += step
    return out or [lo]


def _decimate(pts: Sequence[Tuple[float, float]], cap: int = _MAX_PTS):
    if len(pts) <= cap:
        return list(pts)
    stride = max(1, len(pts) // cap)
    out = list(pts[::stride])
    if out[-1] != pts[-1]:
        out.append(pts[-1])
    return out


# --------------------------------------------------------------------- #
# SVG builders

def _time_axis(t_max: float) -> Tuple[float, str]:
    """Pick a time unit for the x axis; returns (divisor, unit label)."""
    if t_max >= 2 * 86400:
        return 86400.0, "days"
    if t_max >= 2 * 3600:
        return 3600.0, "hours"
    if t_max >= 120:
        return 60.0, "minutes"
    return 1.0, "seconds"


def _xy(t, v, t_max, v_max):
    x = _ML + (t / t_max if t_max > 0 else 0.0) * (_W - _ML - _MR)
    y = _MT + (1.0 - (v / v_max if v_max > 0 else 0.0)) * (_H - _MT - _MB)
    return x, y


def _grid_and_axes(t_max: float, v_max: float, unit_div: float,
                   unit: str, y_fmt=_fmt_num) -> List[str]:
    parts = []
    for yt in _nice_ticks(0.0, v_max, 4):
        _, y = _xy(0.0, yt, t_max, v_max)
        parts.append(
            f'<line class="grid" x1="{_ML}" y1="{y:.1f}" '
            f'x2="{_W - _MR}" y2="{y:.1f}"/>'
        )
        parts.append(
            f'<text class="tick" x="{_ML - 6}" y="{y + 3:.1f}" '
            f'text-anchor="end">{_esc(y_fmt(yt))}</text>'
        )
    for xt in _nice_ticks(0.0, t_max / unit_div, 6):
        x, _ = _xy(xt * unit_div, 0.0, t_max, v_max)
        parts.append(
            f'<text class="tick" x="{x:.1f}" y="{_H - _MB + 16}" '
            f'text-anchor="middle">{_esc(_fmt_num(xt))}</text>'
        )
    parts.append(
        f'<line class="axis" x1="{_ML}" y1="{_H - _MB}" '
        f'x2="{_W - _MR}" y2="{_H - _MB}"/>'
    )
    parts.append(
        f'<text class="tick" x="{_W - _MR}" y="{_H - 4}" '
        f'text-anchor="end">sim time ({unit})</text>'
    )
    return parts


def _mark_lines(
    marks: Optional[Sequence[Tuple[float, str]]], t_max: float, v_max: float
) -> List[str]:
    """Vertical event ticks on a time chart (the Alerts panel's timeline
    marks): a dashed line at each (t, label) with a native
    tooltip — identity never color-alone (the label rides the title and
    the per-detector table repeats every value)."""
    parts: List[str] = []
    for t, label in marks or ():
        x, _ = _xy(t, 0.0, t_max, v_max)
        parts.append(
            f'<line class="mark" x1="{x:.1f}" y1="{_MT}" '
            f'x2="{x:.1f}" y2="{_H - _MB}">'
            f"<title>{_esc(label)} at t = {_esc(_fmt_dur(t))}</title></line>"
        )
    return parts


def _step_series_chart(
    pts: Sequence[Tuple[float, float]],
    *,
    series_var: str,
    label: str,
    t_max: float,
    v_max: Optional[float] = None,
    cap_line: Optional[float] = None,
    area: bool = True,
    hover_fmt=_fmt_num,
    marks: Optional[Sequence[Tuple[float, str]]] = None,
) -> str:
    """One single-series step-after chart (line + optional 10% wash).
    Single series: the panel title names it, so no legend box."""
    pts = _decimate(pts)
    if not pts:
        return '<p class="empty">no samples</p>'
    vmax = v_max if v_max is not None else max(v for _, v in pts)
    if cap_line is not None:
        vmax = max(vmax, cap_line)
    vmax = vmax or 1.0
    unit_div, unit = _time_axis(t_max)
    parts = ['<svg viewBox="0 0 %d %d" role="img" aria-label="%s">'
             % (_W, _H, _esc(label))]
    parts += _grid_and_axes(t_max, vmax, unit_div, unit)
    # step-after path
    path = []
    for i, (t, v) in enumerate(pts):
        x, y = _xy(t, v, t_max, vmax)
        if i == 0:
            path.append(f"M{x:.1f},{y:.1f}")
        else:
            _, py = _xy(pts[i - 1][0], pts[i - 1][1], t_max, vmax)
            path.append(f"L{x:.1f},{py:.1f} L{x:.1f},{y:.1f}")
    d = " ".join(path)
    if area:
        x0, y0 = _xy(pts[0][0], 0.0, t_max, vmax)
        xn, _ = _xy(pts[-1][0], 0.0, t_max, vmax)
        parts.append(
            f'<path d="{d} L{xn:.1f},{y0:.1f} L{x0:.1f},{y0:.1f} Z" '
            f'fill="var({series_var})" opacity="0.1" stroke="none"/>'
        )
    if cap_line is not None:
        _, cy = _xy(0.0, cap_line, t_max, vmax)
        parts.append(
            f'<line class="cap" x1="{_ML}" y1="{cy:.1f}" '
            f'x2="{_W - _MR}" y2="{cy:.1f}"/>'
            f'<text class="tick" x="{_ML + 4}" y="{cy - 4:.1f}">'
            f"capacity {_esc(_fmt_num(cap_line))}</text>"
        )
    parts.append(
        f'<path d="{d}" fill="none" stroke="var({series_var})" '
        f'stroke-width="2" stroke-linejoin="round" stroke-linecap="round"/>'
    )
    parts += _mark_lines(marks, t_max, vmax)
    # hover layer: one invisible hit band per decimated sample with a
    # native tooltip (self-contained; no script needed)
    band = (_W - _ML - _MR) / max(1, len(pts))
    for t, v in pts:
        x, _ = _xy(t, v, t_max, vmax)
        parts.append(
            f'<rect class="hit" x="{x - band / 2:.1f}" y="{_MT}" '
            f'width="{band:.1f}" height="{_H - _MT - _MB}">'
            f"<title>t = {_esc(_fmt_dur(t))}\n{_esc(label)}: "
            f"{_esc(hover_fmt(v))}</title></rect>"
        )
    parts.append("</svg>")
    return "".join(parts)


_SERIES_VARS = ("--series-1", "--series-2", "--series-3", "--series-4",
                "--series-5")


def _multi_step_chart(
    series: List[Tuple[str, List[Tuple[float, float]]]],
    *,
    label: str,
    t_max: float,
    v_max: float = 1.0,
    y_fmt=_fmt_pct,
    cap_line: Optional[float] = None,
    marks: Optional[Sequence[Tuple[float, str]]] = None,
) -> str:
    """Several step-after series on one axis (the network panel's link-
    utilization view; the occupancy panel's demand-vs-physical overlay).
    Identity is never color-alone: each line ends in a direct label and
    carries a native-tooltip ``<title>``."""
    series = [(n, pts) for n, pts in series if pts]
    if not series:
        return '<p class="empty">no samples</p>'
    if cap_line is not None:
        v_max = max(v_max, cap_line)
    unit_div, unit = _time_axis(t_max)
    parts = ['<svg viewBox="0 0 %d %d" role="img" aria-label="%s">'
             % (_W, _H, _esc(label))]
    parts += _grid_and_axes(t_max, v_max, unit_div, unit, y_fmt=y_fmt)
    if cap_line is not None:
        _, cy = _xy(0.0, cap_line, t_max, v_max)
        parts.append(
            f'<line class="cap" x1="{_ML}" y1="{cy:.1f}" '
            f'x2="{_W - _MR}" y2="{cy:.1f}"/>'
            f'<text class="tick" x="{_ML + 4}" y="{cy - 4:.1f}">'
            f"capacity {_esc(_fmt_num(cap_line))}</text>"
        )
    for i, (name, pts) in enumerate(series):
        var = _SERIES_VARS[i % len(_SERIES_VARS)]
        pts = _decimate(pts)
        path = []
        for j, (t, v) in enumerate(pts):
            x, y = _xy(t, min(v, v_max), t_max, v_max)
            if j == 0:
                path.append(f"M{x:.1f},{y:.1f}")
            else:
                _, py = _xy(pts[j - 1][0], min(pts[j - 1][1], v_max), t_max, v_max)
                path.append(f"L{x:.1f},{py:.1f} L{x:.1f},{y:.1f}")
        d = " ".join(path)
        parts.append(
            f'<path d="{d}" fill="none" stroke="var({var})" '
            f'stroke-width="2" stroke-linejoin="round" stroke-linecap="round">'
            f"<title>{_esc(name)}</title></path>"
        )
        ex, ey = _xy(pts[-1][0], min(pts[-1][1], v_max), t_max, v_max)
        parts.append(
            f'<circle cx="{ex:.1f}" cy="{ey:.1f}" r="3.5" fill="var({var})" '
            f'stroke="var(--surface-1)" stroke-width="2"/>'
            f'<text class="dlabel" x="{min(ex + 6, _W - 90):.1f}" '
            f'y="{ey - 5:.1f}">{_esc(name)}</text>'
        )
    parts += _mark_lines(marks, t_max, v_max)
    parts.append("</svg>")
    return "".join(parts)


def _cdf_points(values: Sequence[float]) -> List[Tuple[float, float]]:
    s = sorted(values)
    n = len(s)
    return [(v, (i + 1) / n) for i, v in enumerate(s)]


def _cdf_chart(series: List[Tuple[str, str, List[float]]], label: str) -> str:
    """Multi-series CDF: x = seconds (log-ish linear), y = fraction.
    ``series`` rows are (name, css-var, values).  Legend + direct end
    labels carry identity alongside color."""
    series = [(n, c, v) for n, c, v in series if v]
    if not series:
        return '<p class="empty">no finished jobs</p>'
    x_max = max(max(v) for _, _, v in series) or 1.0
    unit_div, unit = _time_axis(x_max)
    parts = ['<svg viewBox="0 0 %d %d" role="img" aria-label="%s">'
             % (_W, _H, _esc(label))]
    for frac in (0.25, 0.5, 0.75, 1.0):
        _, y = _xy(0.0, frac, x_max, 1.0)
        parts.append(
            f'<line class="grid" x1="{_ML}" y1="{y:.1f}" '
            f'x2="{_W - _MR}" y2="{y:.1f}"/>'
            f'<text class="tick" x="{_ML - 6}" y="{y + 3:.1f}" '
            f'text-anchor="end">{int(frac * 100)}%</text>'
        )
    for xt in _nice_ticks(0.0, x_max / unit_div, 6):
        x, _ = _xy(xt * unit_div, 0.0, x_max, 1.0)
        parts.append(
            f'<text class="tick" x="{x:.1f}" y="{_H - _MB + 16}" '
            f'text-anchor="middle">{_esc(_fmt_num(xt))}</text>'
        )
    parts.append(
        f'<line class="axis" x1="{_ML}" y1="{_H - _MB}" '
        f'x2="{_W - _MR}" y2="{_H - _MB}"/>'
        f'<text class="tick" x="{_W - _MR}" y="{_H - 4}" '
        f'text-anchor="end">{_esc(unit)}</text>'
    )
    for name, var, values in series:
        pts = _decimate(_cdf_points(values))
        d = " ".join(
            ("M" if i == 0 else "L") + f"{_xy(v, f, x_max, 1.0)[0]:.1f},"
            f"{_xy(v, f, x_max, 1.0)[1]:.1f}"
            for i, (v, f) in enumerate(pts)
        )
        parts.append(
            f'<path d="{d}" fill="none" stroke="var({var})" '
            f'stroke-width="2" stroke-linejoin="round" stroke-linecap="round">'
            f"<title>{_esc(name)}</title></path>"
        )
        ex, ey = _xy(pts[-1][0], pts[-1][1], x_max, 1.0)
        parts.append(
            f'<circle cx="{ex:.1f}" cy="{ey:.1f}" r="4" fill="var({var})" '
            f'stroke="var(--surface-1)" stroke-width="2"/>'
            f'<text class="dlabel" x="{min(ex + 6, _W - 60):.1f}" '
            f'y="{ey - 6:.1f}">{_esc(name)}</text>'
        )
    parts.append("</svg>")
    return "".join(parts)


def _stacked_bar(
    legs: List[Tuple[str, float]],
    *,
    label: str,
    unit: str = "chip-s",
    empty_note: str = "nothing to decompose",
) -> str:
    """Part-to-whole: one horizontal stacked bar, 2px surface gaps
    between segments, labels inside where they fit, legend below so
    identity is never color-alone.  Negative legs (an elastic-speedup
    ``policy-share``) cannot be drawn as area; they are skipped in the
    bar but still listed in the legend with their sign."""
    total = sum(v for _, v in legs if v > 0)
    if total <= 0:
        return f'<p class="empty">{_esc(empty_note)}</p>'
    w, y0, bh = 860, 8, 24
    colored = [
        (name, v, _SERIES_VARS[i % len(_SERIES_VARS)])
        for i, (name, v) in enumerate(legs)
    ]
    # legend wraps into rows (the JCT decomposition can carry 8 legs —
    # a single 860px row would clip entries past the viewBox edge) and
    # the viewBox grows to fit every row
    lw = 210
    per_row = max(1, w // lw)
    legend_rows = (len(colored) + per_row - 1) // per_row
    h = y0 + bh + 10 + legend_rows * 16 + 4
    parts = [f'<svg viewBox="0 0 {w} {h}" role="img" '
             f'aria-label="{_esc(label)}">']
    x = 0.0
    for name, v, var in colored:
        seg = (v / total) * (w - 4)
        if seg <= 0:
            continue
        parts.append(
            f'<rect x="{x:.1f}" y="{y0}" width="{max(0.0, seg - 2):.1f}" '
            f'height="{bh}" rx="4" fill="var({var})">'
            f"<title>{_esc(name)}: {_esc(_fmt_num(v))} {_esc(unit)} "
            f"({_esc(_fmt_pct(v / total))})</title></rect>"
        )
        if seg > 150:  # label inside only when it comfortably fits
            parts.append(
                f'<text class="inbar" x="{x + 8:.1f}" y="{y0 + 16}">'
                f"{_esc(name)} {_esc(_fmt_pct(v / total))}</text>"
            )
        x += seg
    for i, (name, v, var) in enumerate(colored):
        # legend: identity never color-alone; wrapped so every entry
        # stays inside the viewBox
        lx = (i % per_row) * lw
        ly = y0 + bh + 10 + (i // per_row) * 16
        parts.append(
            f'<rect x="{lx:.1f}" y="{ly}" width="10" height="10" '
            f'rx="2" fill="var({var})"/>'
            f'<text class="tick" x="{lx + 14:.1f}" y="{ly + 9}">'
            f"{_esc(name)} {_esc(_fmt_num(v))} {_esc(unit)}</text>"
        )
    parts.append("</svg>")
    return "".join(parts)


def _stacked_goodput_bar(gp: dict) -> str:
    """The goodput decomposition as a part-to-whole stacked bar."""
    if gp["total_chip_s"] <= 0:
        return '<p class="empty">no service accrued</p>'
    return _stacked_bar(
        [
            ("useful", gp["useful_chip_s"]),
            ("lost", gp["lost_chip_s"]),
            ("restart overhead", gp["restart_overhead_chip_s"]),
        ],
        label="goodput",
    )


# --------------------------------------------------------------------- #
# HTML assembly

_CSS = """
:root { color-scheme: light dark; }
body {
  margin: 0; padding: 24px;
  font-family: system-ui, -apple-system, "Segoe UI", sans-serif;
  background: var(--page); color: var(--text-primary);
}
.viz-root {
  --surface-1: #fcfcfb; --page: #f9f9f7;
  --text-primary: #0b0b0b; --text-secondary: #52514e; --muted: #898781;
  --grid: #e1e0d9; --baseline: #c3c2b7;
  --series-1: #2a78d6; --series-2: #eb6834; --series-3: #1baf7a;
  --series-4: #9556c7; --series-5: #c23f87;
  --border: rgba(11,11,11,0.10);
}
@media (prefers-color-scheme: dark) {
  :root:where(:not([data-theme="light"])) .viz-root {
    --surface-1: #1a1a19; --page: #0d0d0d;
    --text-primary: #ffffff; --text-secondary: #c3c2b7; --muted: #898781;
    --grid: #2c2c2a; --baseline: #383835;
    --series-1: #3987e5; --series-2: #d95926; --series-3: #199e70;
    --series-4: #a365d6; --series-5: #d052a0;
    --border: rgba(255,255,255,0.10);
  }
}
:root[data-theme="dark"] .viz-root {
  --surface-1: #1a1a19; --page: #0d0d0d;
  --text-primary: #ffffff; --text-secondary: #c3c2b7; --muted: #898781;
  --grid: #2c2c2a; --baseline: #383835;
  --series-1: #3987e5; --series-2: #d95926; --series-3: #199e70;
  --series-4: #a365d6; --series-5: #d052a0;
  --border: rgba(255,255,255,0.10);
}
body { background: var(--page); }
h1 { font-size: 20px; margin: 0 0 4px; }
h2 { font-size: 15px; margin: 24px 0 8px; }
.meta { color: var(--text-secondary); font-size: 13px; margin-bottom: 16px; }
.meta code { background: none; color: inherit; }
.panel {
  background: var(--surface-1); border: 1px solid var(--border);
  border-radius: 8px; padding: 16px; margin-bottom: 16px;
}
.kpis { display: flex; flex-wrap: wrap; gap: 12px; }
.tile {
  background: var(--surface-1); border: 1px solid var(--border);
  border-radius: 8px; padding: 12px 16px; min-width: 130px; flex: 1;
}
.tile .label { font-size: 12px; color: var(--text-secondary); }
.tile .value { font-size: 26px; font-weight: 600; margin-top: 2px; }
.tile .sub { font-size: 12px; color: var(--muted); margin-top: 2px; }
svg { width: 100%; height: auto; display: block; }
svg .grid { stroke: var(--grid); stroke-width: 1; }
svg .axis { stroke: var(--baseline); stroke-width: 1; }
svg .cap { stroke: var(--baseline); stroke-width: 1; stroke-dasharray: none; }
svg .mark { stroke: var(--series-2); stroke-width: 1.5; stroke-dasharray: 4 3; }
svg .tick { fill: var(--muted); font-size: 11px; }
svg .dlabel { fill: var(--text-secondary); font-size: 12px; }
svg .inbar { fill: #ffffff; font-size: 12px; }
svg .hit { fill: transparent; }
svg .hit:hover { fill: var(--text-primary); fill-opacity: 0.05; }
table { border-collapse: collapse; font-size: 13px; width: 100%; }
th, td { text-align: right; padding: 4px 10px; border-bottom: 1px solid var(--grid); }
th:first-child, td:first-child { text-align: left; }
th { color: var(--text-secondary); font-weight: 600; }
td { font-variant-numeric: tabular-nums; }
.empty { color: var(--muted); font-size: 13px; }
.integrity { color: var(--muted); font-size: 12px; margin-top: 16px; }
"""


def _tile(label: str, value: str, sub: str = "") -> str:
    sub_html = f'<div class="sub">{_esc(sub)}</div>' if sub else ""
    return (
        f'<div class="tile"><div class="label">{_esc(label)}</div>'
        f'<div class="value">{_esc(value)}</div>{sub_html}</div>'
    )


def _dist_table(dists: dict) -> str:
    rows = []
    fmt = {
        "wait": _fmt_dur, "run": _fmt_dur, "jct": _fmt_dur,
        "slowdown": lambda v: "–" if v is None else f"{v:.2f}x",
        "preempt_count": _fmt_num, "fault_count": _fmt_num,
    }
    for name, block in dists.items():
        f = fmt.get(name, _fmt_num)
        rows.append(
            f"<tr><td>{_esc(name)}</td><td>{block['n']}</td>"
            + "".join(
                f"<td>{_esc(f(block[q]))}</td>"
                for q in ("mean", "p50", "p95", "p99", "max")
            )
            + "</tr>"
        )
    return (
        "<table><thead><tr><th>metric</th><th>n</th><th>mean</th>"
        "<th>p50</th><th>p95</th><th>p99</th><th>max</th></tr></thead>"
        f"<tbody>{''.join(rows)}</tbody></table>"
    )


def _fault_kind_table(attribution: dict) -> str:
    rows = []
    for kind, row in attribution["kinds"].items():
        rows.append(
            f"<tr><td>{_esc(kind)}</td><td>{row['faults']}</td>"
            f"<td>{row['revocations']}</td>"
            f"<td>{row.get('warned_revocations', 0)}</td>"
            f"<td>{_esc(_fmt_dur(row['lost_work_s']))}</td>"
            f"<td>{_esc(_fmt_num(row['lost_chip_s']))}</td>"
            f"<td>{_esc(_fmt_dur(row['restore_charged_s']))}</td></tr>"
        )
    return (
        "<table><thead><tr><th>fault kind</th><th>outages</th>"
        "<th>revocations</th><th>warned</th><th>work lost</th>"
        "<th>chip-s lost</th><th>restore charged</th></tr></thead>"
        f"<tbody>{''.join(rows)}</tbody></table>"
    )


def _domain_table(domains: dict) -> str:
    """Per-domain outage table (correlated ``domain`` faults): which
    hosts/racks/pods went down, how often, and for how long."""
    rows = []
    for scope, row in domains.items():
        rows.append(
            f"<tr><td>{_esc(scope)}</td><td>{_esc(row.get('level') or '–')}</td>"
            f"<td>{row['outages']}</td>"
            f"<td>{_esc(_fmt_dur(row['down_s']))}</td></tr>"
        )
    return (
        "<table><thead><tr><th>failure domain</th><th>level</th>"
        "<th>outages</th><th>down time</th></tr></thead>"
        f"<tbody>{''.join(rows)}</tbody></table>"
    )


def _net_jobs_table(net: dict) -> str:
    rows = []
    for j in net["jobs"]:
        share = j["mean_share"]
        rows.append(
            f"<tr><td>{_esc(j['job_id'])}</td><td>{j['chips']}</td>"
            f"<td>{_esc(_fmt_num(j['mean_bw_gbps']))}</td>"
            f"<td>{_esc(_fmt_num(j['demand_gbps']))}</td>"
            f"<td>{_esc(_fmt_pct(share))}</td>"
            f"<td>{j['net_updates']}</td></tr>"
        )
    if not rows:
        return '<p class="empty">no multislice job was priced</p>'
    return (
        "<table><thead><tr><th>job</th><th>chips</th>"
        "<th>mean bw (Gbps)</th><th>demand (Gbps)</th><th>mean share</th>"
        "<th>re-prices</th></tr></thead>"
        f"<tbody>{''.join(rows)}</tbody></table>"
    )


def _net_links_table(analysis: RunAnalysis, net: dict) -> str:
    rows = []
    for name, info in net["links"].items():
        rows.append(
            f"<tr><td>{_esc(name)}</td>"
            f"<td>{_esc(_fmt_pct(info['mean_util']))}</td>"
            f"<td>{_esc(_fmt_num(info['last_capacity_gbps']))}</td>"
            f"<td>{info['samples']}</td></tr>"
        )
    return (
        "<table><thead><tr><th>link</th><th>mean util</th>"
        "<th>capacity (Gbps)</th><th>changes</th></tr></thead>"
        f"<tbody>{''.join(rows)}</tbody></table>"
    )


def _slowest_jobs_table(analysis: RunAnalysis, n: int = 10) -> str:
    # heapq.nlargest == sorted(..., reverse=True)[:n] (documented, ties
    # broken identically) without materializing the full finished list —
    # the bounded-memory analyzer streams jobs from its spill
    # store, and this table must not pull them all back into RAM
    worst = heapq.nlargest(
        n,
        (r for r in analysis.jobs if r.finished and r.jct() is not None),
        key=lambda r: r.jct(),
    )
    if not worst:
        return '<p class="empty">no finished jobs</p>'
    # straggler slowdown column: only when the run attributed
    # any time to a degraded chip — fault-free reports keep their shape
    stragglers = any(r.delay_legs.get("straggler") for r in analysis.jobs)
    rows = []
    for r in worst:
        straggler_cell = (
            f"<td>{_esc(_fmt_dur(r.delay_legs.get('straggler', 0.0)))}</td>"
            if stragglers else ""
        )
        rows.append(
            f"<tr><td>{_esc(r.job_id)}</td><td>{r.chips}</td>"
            f"<td>{_esc(_fmt_dur(r.wait()))}</td>"
            f"<td>{_esc(_fmt_dur(r.jct()))}</td>"
            f"<td>{'–' if r.slowdown() is None else f'{r.slowdown():.1f}x'}</td>"
            f"<td>{r.preempts}</td><td>{r.faults}</td>"
            f"{straggler_cell}"
            f"<td>{_esc(r.end_state)}</td></tr>"
        )
    straggler_head = "<th>straggler</th>" if stragglers else ""
    return (
        "<table><thead><tr><th>job</th><th>chips</th><th>wait</th>"
        "<th>JCT</th><th>slowdown</th><th>preempts</th><th>faults</th>"
        f"{straggler_head}<th>end</th></tr></thead>"
        f"<tbody>{''.join(rows)}</tbody></table>"
    )


def _cache_table(cache_stats: dict) -> str:
    """The Engine-health cache hit-rate table: one row per
    unified cache with its hit/miss/other counts and the hit rate over
    hits + misses (invalidate/fallback are listed but excluded from the
    rate — they are lifecycle events, not lookups)."""
    rows = []
    for name in sorted(cache_stats):
        outcomes = cache_stats[name] or {}
        hit = float(outcomes.get("hit", 0))
        miss = float(outcomes.get("miss", 0))
        other = {
            k: v for k, v in sorted(outcomes.items())
            if k not in ("hit", "miss")
        }
        lookups = hit + miss
        rate = (hit / lookups) if lookups > 0 else None
        other_s = (
            ", ".join(f"{k} {_fmt_num(float(v))}" for k, v in other.items())
            or "–"
        )
        rows.append(
            f"<tr><td>{_esc(name)}</td><td>{_esc(_fmt_num(hit))}</td>"
            f"<td>{_esc(_fmt_num(miss))}</td>"
            f"<td>{_esc(_fmt_pct(rate))}</td>"
            f"<td>{_esc(other_s)}</td></tr>"
        )
    return (
        "<table><thead><tr><th>cache</th><th>hits</th><th>misses</th>"
        "<th>hit rate</th><th>other events</th></tr></thead>"
        f"<tbody>{''.join(rows)}</tbody></table>"
    )


def _engine_health_panel(
    analysis: RunAnalysis, selfprof: Optional[dict]
) -> str:
    """The engine's view of itself: where the replay's *wall*
    time went (the self-profile phase decomposition) and whether the
    caches are still earning their keep (hit-rate table from the
    run's trailing ``cache`` record).  Absent when the run carried
    neither signal."""
    cache_stats = getattr(analysis, "cache_stats", None) or {}
    if not selfprof and not cache_stats:
        return ""
    parts = ['<h2>Engine health</h2>\n<div class="panel">']
    if selfprof:
        phases = selfprof.get("phases", {})
        # pipeline order (obs/selfprof.py PHASES), not the JSON
        # document's alphabetical key order; unknown names trail
        from gpuschedule_tpu_torch.obs.selfprof import PHASES as _PHASE_ORDER

        ordered = [p for p in _PHASE_ORDER if p in phases] + [
            p for p in sorted(phases) if p not in _PHASE_ORDER
        ]
        legs = [
            (name, float(phases[name].get("total_s", 0.0)))
            for name in ordered
        ]
        total = selfprof.get("total_wall_s")
        batches = selfprof.get("batches")
        meta = []
        if total is not None:
            meta.append(f"replay wall time {_esc(_fmt_dur(float(total)))}")
        if batches:
            meta.append(f"{int(batches):,} batches")
            if total:
                meta.append(f"{_esc(_fmt_num(batches / total))} batches/s")
        parts.append(
            f'<p class="meta">{" · ".join(meta)} — wall-clock phase '
            f"decomposition (run --self-profile)</p>"
        )
        parts.append(_stacked_bar(
            legs, label="replay wall time by phase", unit="s",
            empty_note="no wall time recorded",
        ))
    if cache_stats:
        parts.append(
            '<p class="meta">engine cache telemetry '
            "(engine_cache_events)</p>"
        )
        parts.append(_cache_table(cache_stats))
    parts.append("</div>")
    return "\n".join(parts)


def _occupancy_chart(
    analysis: RunAnalysis,
    occ_pts: List[Tuple[float, float]],
    t_max: float,
    total_chips: Optional[int],
    alert_marks: Optional[List[Tuple[float, str]]] = None,
) -> str:
    """The occupancy panel's chart: the demand series alone (historic
    view), or — when the run carried cluster ``sample`` events — demand
    overlaid on *physical* occupancy.  Demand above physical is overlay
    packing made visible; physical above zero while demand gaps are health holes.
    ``alert_marks`` (the watchtower's detections) draw as
    dashed timeline ticks."""
    phys_pts = [(t, float(u)) for t, u, _, _ in analysis.sample_series]
    if not phys_pts:
        return _step_series_chart(
            occ_pts, series_var="--series-1", label="chips allocated",
            t_max=t_max,
            cap_line=float(total_chips) if total_chips else None,
            marks=alert_marks,
        )
    v_max = max(
        max((v for _, v in occ_pts), default=1.0),
        max(v for _, v in phys_pts),
        1.0,
    )
    return _multi_step_chart(
        [("demand", occ_pts), ("physical", phys_pts)],
        label="chip occupancy: demand vs physical",
        t_max=t_max, v_max=v_max, y_fmt=_fmt_num,
        cap_line=float(total_chips) if total_chips else None,
        marks=alert_marks,
    )


def _alerts_panel(alerts: List[dict]) -> str:
    """The watchtower panel: one row per alert (time,
    detector, severity, value vs threshold, blamed cause) plus a
    per-detector rollup — the table half of the occupancy chart's
    timeline ticks, so no detection is reachable only through a mark."""
    rows = []
    per: dict = {}
    for a in alerts:
        det = str(a.get("detector", "?"))
        per[det] = per.get(det, 0) + 1
        rows.append(
            f"<tr><td>{_esc(_fmt_dur(float(a.get('t', 0.0))))}</td>"
            f"<td>{_esc(det)}</td>"
            f"<td>{_esc(a.get('severity', '–'))}</td>"
            f"<td>{_esc(_fmt_num(a.get('value')))}</td>"
            f"<td>{_esc(_fmt_num(a.get('threshold')))}</td>"
            f"<td>{_esc(a.get('cause', '–'))}</td></tr>"
        )
    rollup = " · ".join(
        f"{det} ×{n}" for det, n in sorted(per.items())
    )
    return f"""
<h2>Alerts</h2>
<div class="panel">
  <p class="meta">{len(alerts)} watchtower detections — {_esc(rollup)}</p>
  <table><thead><tr><th>t</th><th>detector</th><th>severity</th>
  <th>value</th><th>threshold</th><th>blamed cause</th></tr></thead>
  <tbody>{''.join(rows)}</tbody></table>
</div>"""


def render_report(
    analysis: RunAnalysis,
    *,
    title: Optional[str] = None,
    selfprof: Optional[dict] = None,
    alerts: Optional[List[dict]] = None,
) -> str:
    """The whole report as one HTML string (write it anywhere; it never
    references the network or the filesystem).  ``selfprof`` (the
    summary block of a ``run --self-profile`` document, via
    ``report --selfprof``) adds the wall-clock phase bar to the
    Engine-health panel; ``alerts`` (the watchtower side stream, via
    ``report --alerts``) adds timeline ticks on the occupancy chart and
    the per-detector Alerts panel."""
    h = analysis.header
    s = analysis.summary()
    dists = analysis.distributions()
    attribution = analysis.fault_attribution()
    gp = attribution["goodput"]
    title = title or (
        f"Run report — {h.policy or 'unknown policy'}" if h else "Run report"
    )
    meta_bits = []
    if h is not None:
        meta_bits = [
            f"run <code>{_esc(h.run_id or '?')}</code>",
            f"policy <code>{_esc(h.policy or '?')}</code>",
            f"seed <code>{_esc(h.seed)}</code>",
            f"config <code>{_esc(h.config_hash or '?')}</code>",
            f"schema {h.schema}",
        ]
    meta_bits.append(f"{analysis.num_events:,} events")
    meta_bits.append(f"span {_fmt_dur(analysis.end_t)}")

    t_max = analysis.end_t or 1.0
    occ_pts = [(t, float(used)) for t, used, _, _ in analysis.util_series]
    pend_pts = [(t, float(p)) for t, _, _, p in analysis.util_series]
    total_chips = h.total_chips if h else None

    # one streaming pass for the CDF inputs: only the float values stay
    # resident, never the records — the bounded-memory analyzer
    # may be feeding jobs from its spill store, and materializing the
    # finished list here would defeat it.  Same values in the same jobs
    # order as the old list comprehensions, so the charts are byte-equal.
    waits: List[float] = []
    jcts: List[float] = []
    for r in analysis.jobs:
        if r.finished:
            w = r.wait()
            if w is not None:
                waits.append(w)
            j = r.jct()
            if j is not None:
                jcts.append(j)

    kpis = [
        _tile("Finished jobs", _fmt_num(s["num_finished"]),
              f"{s['num_unfinished']} unfinished · {s['num_rejected']} rejected"),
        _tile("Avg JCT", _fmt_dur(s["avg_jct"]),
              f"p99 {_fmt_dur(dists['jct']['p99'])}"),
        _tile("p99 wait", _fmt_dur(dists["wait"]["p99"]),
              f"p50 {_fmt_dur(dists['wait']['p50'])}"),
        _tile("Mean occupancy", _fmt_pct(s["mean_occupancy"]),
              (f"physical {_fmt_pct(s['mean_phys_occupancy'])} · "
               if s.get("mean_phys_occupancy") is not None else "")
              + f"frag {_fmt_pct(s['mean_fragmentation'])}"),
        _tile("Useful goodput", _fmt_pct(s["useful_frac"]),
              f"{_fmt_num(gp['total_chip_s'])} chip-s total"),
    ]

    alert_marks = [
        (float(a.get("t", 0.0)), f"{a.get('detector', '?')} alert")
        for a in (alerts or [])
    ]
    alerts_panel = _alerts_panel(alerts) if alerts else ""

    net = analysis.network()
    # three-way net-degraded split: rendered whenever any job
    # ran below locality 1.0 — with or without the contention model
    # (network() already derived it; don't rescan the job list)
    split = net["net_degraded_split"]
    split_panel = ""
    if split:
        split_panel = (
            '<p class="meta">net-degraded stretch by segment</p>'
            + _stacked_bar(
                sorted(split.items()), label="net-degraded split", unit="s",
                empty_note="no net-degraded time",
            )
        )
    net_panel = ""
    if analysis.net_links:
        max_links = 6  # core + 5 busiest uplinks; the table lists them all
        by_load = sorted(
            analysis.net_links,
            key=lambda n: (n != "core", -(analysis.net_link_means.get(n) or 0.0), n),
        )
        link_series = [
            # same 0/0 rule as LinkSample.util: a dead link carrying no
            # traffic is 0% (idle), not 100% — the table agrees
            (name, [(t, (u / c) if c > 0 else (1.0 if u > 0 else 0.0))
                    for t, u, c in analysis.net_links[name]])
            for name in by_load[:max_links]
        ]
        dropped = len(analysis.net_links) - len(link_series)
        drop_note = (
            f'<p class="meta">{dropped} more uplinks in the table below</p>'
            if dropped > 0 else ""
        )
        net_panel = f"""
<h2>Network</h2>
<div class="panel">
  <p class="meta">{s['net_reprices']} bandwidth re-prices ·
  {len(net['jobs'])} multislice jobs priced</p>
  {_multi_step_chart(link_series, label='link utilization', t_max=t_max)}
  {drop_note}
  {_net_links_table(analysis, net)}
  {_net_jobs_table(net)}
  {split_panel}
</div>"""
    elif split_panel:
        # no contention model, but static tolls / GPU tiers stretched
        # run time: the split still gets its panel
        net_panel = f"""
<h2>Network</h2>
<div class="panel">
  {split_panel}
</div>"""

    # Attribution panel: where wait and JCT time went, cause by
    # cause — rendered only for attribution-armed captures.
    attrib_panel = ""
    legs = analysis.delay_by_cause()
    if legs:
        at = analysis.attribution()
        wait_total = sum(at["wait_s"].values())
        cause_rows = "".join(
            f"<tr><td>{_esc(k)}</td>"
            f"<td>{_esc(_fmt_dur(v))}</td>"
            f"<td>{_esc(_fmt_pct(v / wait_total) if wait_total > 0 else '–')}</td>"
            f"<td>{_esc(_fmt_num(at['chip_demand_wait_s'].get(k)))}</td></tr>"
            for k, v in at["wait_s"].items()
        )
        run_rows = "".join(
            f"<tr><td>{_esc(k)}</td><td>{_esc(_fmt_dur(v))}</td>"
            f"<td>–</td><td>–</td></tr>"
            for k, v in at["run_s"].items()
        )
        jct_legs = [(k, v) for k, v in (*at["wait_s"].items(),
                                        *at["run_s"].items())]
        attrib_panel = f"""
<h2>Attribution — why was time lost?</h2>
<div class="panel">
  <p class="meta">per-cause wait across all jobs (the blame decomposition;
  legs sum to the analyzer's wait exactly)</p>
  {_stacked_bar(list(at['wait_s'].items()), label='wait by cause',
                unit='s', empty_note='no job ever waited')}
  <p class="meta">full JCT decomposition: waits + work + slowdown
  stretches + restart overhead</p>
  {_stacked_bar(jct_legs, label='time by leg', unit='s')}
  <table><thead><tr><th>leg</th><th>seconds</th><th>share of wait</th>
  <th>chip-demand-s</th></tr></thead>
  <tbody>{cause_rows}{run_rows}</tbody></table>
  <p class="meta">decomposition residuals: wait
  {at['max_wait_residual']:.2e} · JCT {at['max_jct_residual']:.2e}</p>
</div>"""

    fault_panel = ""
    pro = getattr(analysis, "proactive", None) or {}
    if s["faults"] or s["revocations"] or gp["lost_chip_s"] > 0 or pro:
        kinds = attribution["kinds"]
        lost_total = sum(k["lost_work_s"] for k in kinds.values())
        lost_warned = sum(k.get("lost_work_warned_s", 0.0)
                          for k in kinds.values())
        n_warned = sum(k.get("warned_revocations", 0) for k in kinds.values())
        warned_note = ""
        if n_warned:
            # priced recovery: how much of the rollback an
            # emergency checkpoint caught vs what unwarned revocations
            # forfeited
            warned_note = (
                f" · {n_warned} warned revocations lost "
                f"{_esc(_fmt_dur(lost_warned))} vs "
                f"{_esc(_fmt_dur(lost_total - lost_warned))} unwarned"
            )
        domains = attribution.get("domains") or {}
        domain_table = (
            f"<p class=\"meta\">correlated domain outages</p>"
            f"{_domain_table(domains)}" if domains else ""
        )
        proactive_note = ""
        if pro.get("migrations"):
            # hazard-driven checkpoint-then-migrate: what the
            # moves insured against vs what they cost — avoided-loss
            # measurable against lost-work in one line
            proactive_note = (
                f"<p class=\"meta\">proactive migration: "
                f"{int(pro['migrations'])} moves avoided "
                f"{_esc(_fmt_dur(pro.get('avoided_s', 0.0)))} of exposed "
                f"work for {_esc(_fmt_dur(pro.get('overhead_s', 0.0)))} "
                f"checkpoint+restore overhead paid</p>"
            )
        fault_panel = f"""
<h2>Faults</h2>
<div class="panel">
  <p class="meta">{s['faults']} outages · {s['revocations']} revocations ·
  {s['repairs']} repairs · {_esc(_fmt_dur(lost_total))} work
  lost{warned_note}</p>
  {_stacked_goodput_bar(gp)}
  {proactive_note}
  {_fault_kind_table(attribution)}
  {domain_table}
</div>"""

    integrity = (
        f"stream integrity: max analyzer-vs-engine progress drift "
        f"{analysis.max_progress_drift:.2e}"
        + (
            f" · {analysis.counts.get('anomalies', 0)} anomalies"
            if analysis.counts.get("anomalies") else ""
        )
    )

    return f"""<!DOCTYPE html>
<html lang="en">
<head>
<meta charset="utf-8">
<meta name="viewport" content="width=device-width, initial-scale=1">
<title>{_esc(title)}</title>
<style>{_CSS}</style>
</head>
<body class="viz-root">
<h1>{_esc(title)}</h1>
<p class="meta">{' · '.join(meta_bits)}</p>
<div class="kpis">{''.join(kpis)}</div>

<h2>Chip occupancy</h2>
<div class="panel">
{_occupancy_chart(analysis, occ_pts, t_max, total_chips, alert_marks)}
</div>
{alerts_panel}

<h2>Pending queue</h2>
<div class="panel">
{_step_series_chart(pend_pts, series_var='--series-2', label='jobs waiting',
                    t_max=t_max, area=False)}
</div>

<h2>Wait &amp; completion-time CDF</h2>
<div class="panel">
{_cdf_chart([('wait', '--series-1', waits), ('JCT', '--series-2', jcts)],
            'wait and JCT CDF')}
</div>
{attrib_panel}
{net_panel}
{fault_panel}
{_engine_health_panel(analysis, selfprof)}
<h2>Distributions</h2>
<div class="panel">{_dist_table(dists)}</div>

<h2>Slowest jobs</h2>
<div class="panel">{_slowest_jobs_table(analysis)}</div>

<p class="integrity">{_esc(integrity)}</p>
</body>
</html>
"""


def write_report(
    analysis: RunAnalysis,
    path,
    *,
    title: Optional[str] = None,
    selfprof: Optional[dict] = None,
    alerts: Optional[List[dict]] = None,
) -> Path:
    out = Path(path)
    if out.parent and not out.parent.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(render_report(
        analysis, title=title, selfprof=selfprof, alerts=alerts
    ))
    return out
