"""Minimal HOCON-subset parser + reference-config adapter (port of
``mvsdf_tpu/hocon.py``).

The reference configures architecture/training via pyhocon .conf files
(``code/confs/mvsdf_dtu.conf``, parsed at ``idr_train.py:23``). pyhocon is
not available here; this self-contained parser covers the subset those
files use: nested ``name { ... }`` blocks, ``key = value`` with scalars,
lists, fractions kept as strings, booleans, and ``//``/``#`` comments.

``config_from_hocon`` maps a parsed reference conf onto the port's typed
MVSDFConfig tree so reference .conf files drive the port directly.
"""
from __future__ import annotations

import re
from typing import Any, Dict


def _parse_value(tok: str):
    t = tok.strip()
    if t.lower() in ("true", "yes"):
        return True
    if t.lower() in ("false", "no"):
        return False
    if t.startswith("[") and t.endswith("]"):
        inner = t[1:-1].strip()
        if not inner:
            return []
        return [_parse_value(v) for v in inner.split(",")]
    if re.fullmatch(r"[+-]?\d+", t):
        return int(t)
    if re.fullmatch(r"[+-]?(\d+\.?\d*|\.\d+)([eE][+-]?\d+)?", t):
        return float(t)
    if t.startswith('"') and t.endswith('"'):
        return t[1:-1]
    # Bare tokens are accepted only in shapes the reference confs use:
    # identifiers (mode = idr, expname = mvsdf) and fractions (4/6).
    # Anything else — typically a typo'd number like 1e-4x or 0.0.1 —
    # fails loud here instead of flowing downstream as a string.
    if re.fullmatch(r"[A-Za-z_][\w.\-]*", t) or \
            re.fullmatch(r"[+-]?\d+\s*/\s*\d+", t):
        return t
    raise ValueError(f"cannot parse conf scalar: {t!r}")


def parse_hocon(text: str) -> Dict[str, Any]:
    # strip comments
    lines = []
    for raw in text.splitlines():
        line = re.sub(r"(//|#).*$", "", raw).rstrip()
        if line.strip():
            lines.append(line)
    root: Dict[str, Any] = {}
    stack = [root]
    pending_key = None
    for line in lines:
        s = line.strip()
        while s:
            if pending_key is not None:
                if s.startswith("{"):
                    new: Dict[str, Any] = {}
                    stack[-1][pending_key] = new
                    stack.append(new)
                    pending_key = None
                    s = s[1:].strip()
                    continue
                raise ValueError(f"expected '{{' after {pending_key}")
            m = re.match(r"^([\w.]+)\s*\{", s)
            if m:
                new = {}
                stack[-1][m.group(1)] = new
                stack.append(new)
                s = s[m.end():].strip()
                continue
            if s.startswith("}"):
                stack.pop()
                s = s[1:].strip()
                continue
            m = re.match(r"^([\w.]+)\s*=\s*(.+?)(?=\s*}\s*$|$)", s)
            if m:
                stack[-1][m.group(1)] = _parse_value(m.group(2))
                s = s[m.end():].strip()
                continue
            m = re.match(r"^([\w.]+)\s*$", s)
            if m:
                pending_key = m.group(1)
                s = ""
                continue
            raise ValueError(f"cannot parse: {line!r}")
    return root


def _frac(v, default):
    if isinstance(v, str) and "/" in v:
        a, b = v.split("/")
        return float(a) / float(b)
    if isinstance(v, (int, float)):
        return float(v)
    return default


def config_from_hocon(path: str):
    """Reference .conf -> MVSDFConfig (architecture + train hyperparams).

    Loss-schedule settings live in the reference's python conf module
    (``code/model/conf.py``), mirrored by Schedule defaults."""
    from .config import MVSDFConfig, ModelConfig, Schedule, TrainConfig
    from .fields.sdf import ImplicitConfig
    from .fields.radiance import RenderConfig
    from .tracing.sphere_trace import TracerConfig

    with open(path) as f:
        conf = parse_hocon(f.read())
    model = conf.get("model", {})
    train = conf.get("train", {})
    fvs = int(model.get("feature_vector_size", 256))
    imp = model.get("implicit_network", {})
    ren = model.get("rendering_network", {})
    rt = model.get("ray_tracer", {})

    icfg = ImplicitConfig(
        feature_vector_size=fvs,
        d_in=int(imp.get("d_in", 3)),
        d_out=int(imp.get("d_out", 1)),
        dims=tuple(imp.get("dims", [512] * 8)),
        geometric_init=bool(imp.get("geometric_init", True)),
        bias=float(imp.get("bias", 1.0)),
        skip_in=tuple(imp.get("skip_in", [])),
        weight_norm=bool(imp.get("weight_norm", True)),
        multires=int(imp.get("multires", 0)))
    rcfg = RenderConfig(
        feature_vector_size=fvs,
        mode=str(ren.get("mode", "idr")),
        d_in=int(ren.get("d_in", 9)),
        d_out=int(ren.get("d_out", 3)),
        dims=tuple(ren.get("dims", [512] * 4)),
        weight_norm=bool(ren.get("weight_norm", True)),
        multires_view=int(ren.get("multires_view", 0)))
    tcfg = TracerConfig(
        object_bounding_sphere=float(rt.get("object_bounding_sphere", 1.0)),
        sdf_threshold=float(rt.get("sdf_threshold", 5e-5)),
        line_search_step=float(rt.get("line_search_step", 0.5)),
        line_step_iters=int(rt.get("line_step_iters", 1)),
        sphere_tracing_iters=int(rt.get("sphere_tracing_iters", 10)),
        n_steps=int(rt.get("n_steps", 100)),
        n_secant_steps=int(rt.get("n_secant_steps", 8)))

    milestones = tuple(_frac(v, None) for v in
                       train.get("sched_milestones", ["4/6", "5/6"]))
    tr = TrainConfig(
        learning_rate=float(train.get("learning_rate", 2e-4)),
        num_pixels=int(train.get("num_pixels", 4096)),
        sched_milestones=milestones,
        sched_factor=float(train.get("sched_factor", 0.1)),
        plot_freq=_frac(train.get("plot_freq", "1/12"), 1 / 12))

    # optional schedule{} block: the analog of swapping the reference's
    # loss-schedule module via IDR_CONF/IDR_USE_ENV (conf.py:3-33,
    # implicit_differentiable_renderer.py:15-17) — any Schedule field can
    # be overridden from the conf file; unknown keys fail loud.
    sched_conf = conf.get("schedule", {})
    sched_kwargs = {}
    defaults = Schedule()
    for key, val in sched_conf.items():
        if not hasattr(defaults, key):
            raise ValueError(f"unknown schedule field {key!r} in {path}")
        cur = getattr(defaults, key)
        if isinstance(cur, tuple):
            vals = val if isinstance(val, list) else [val]
            sched_kwargs[key] = tuple(
                _frac(v, None) if isinstance(v, str) else v for v in vals)
        elif isinstance(cur, bool):
            sched_kwargs[key] = bool(val)
        elif isinstance(cur, float):
            sched_kwargs[key] = _frac(val, None) if isinstance(val, str) \
                else float(val)
        elif isinstance(cur, int):
            sched_kwargs[key] = int(val)
        else:
            sched_kwargs[key] = val

    return MVSDFConfig(model=ModelConfig(implicit=icfg, render=rcfg,
                                         tracer=tcfg),
                       schedule=Schedule(**sched_kwargs), train=tr)
