"""The comparison that decides ``correct``: the frames the timed path made
against the plain reference's frames for the same inputs.

Numbers compared (each against its limit in ``benchmark/limits/<cell>.json``):

- ``tri_id_off``: samples whose winning triangle differs from the
  reference's, over every compared frame that kept its visibility planes;
- ``depth_q_gap``: the largest gap of quantized depth over the samples
  whose winner agrees;
- ``color_gap``: the largest gap of any channel of the colour that left the
  timed path (the host image of a present cell, the device colours of a
  sequence) over every pixel of every compared frame.
"""

from __future__ import annotations

import numpy as np
import torch

from ..reference import render as ref_render


def numbers(frames: list, reference) -> dict:
    """``reference(t)`` is the reference Frame at animation time ``t``."""
    out = {"color_gap": 0.0}
    vis = any("tri_id" in f for f in frames)
    if vis:
        out.update(tri_id_off=0, depth_q_gap=0)
    for f in frames:
        ref = reference(f["t"])
        color = f["color"]
        if isinstance(color, np.ndarray):  # a host image (H, W, 4)
            color = torch.from_numpy(color).permute(2, 0, 1)
        gap = (color.to(ref.color.device, torch.float32) - ref.color).abs()
        out["color_gap"] = max(out["color_gap"], float(gap.max()) if not bool(gap.isnan().any()) else float("nan"))
        if "tri_id" in f:
            tid = f["tri_id"].to(ref.tri_id.device).reshape(ref.tri_id.shape)
            dq = f["depth_q"].to(ref.depth_q.device).reshape(ref.depth_q.shape)
            same = tid == ref.tri_id
            out["tri_id_off"] += int((~same).sum())
            dgap = (dq.to(torch.int64) - ref.depth_q.to(torch.int64)).abs()[same]
            out["depth_q_gap"] = max(out["depth_q_gap"], int(dgap.max()) if dgap.numel() else 0)
    return out


def judge(values: dict, limits: dict) -> tuple[bool, dict]:
    """(all within their limits, {name: {"value", "limit"}}); a number with
    no limit is an error, a NaN is out of its limit."""
    missing = sorted(set(values) - set(limits))
    if missing:
        raise KeyError(f"no limit for {missing}")
    checks = {k: {"value": v, "limit": limits[k]} for k, v in values.items()}
    return all(v <= limits[k] for k, v in values.items()), checks


def reference_for(cfg: dict, scene, attrs: dict, aspect: float, precision: str = "float32",
                  instances: dict | None = None):
    """The function from animation time to the reference Frame of ``cfg``,
    drawing ``attrs`` once per instance of ``instances`` (the scene's)."""
    args = cfg.get("scene_args", {})

    def frame(t):
        return ref_render.render(cfg["reference"], attrs, scene.uniforms(t, aspect, args), cfg["width"],
                                 cfg["height"], cfg["msaa"], precision, instances=instances)

    return frame
