"""One frame of the plain reference: vertex stage, near-plane slots, the
spec's raster (``raster.py``), perspective-correct interpolation at the
winner's pixel centre, the fragment shader, and the coverage resolve.

It imports nothing of the program.  Its inputs are the benchmark's own:
the scene's mesh attributes, instances and uniforms, and the
configuration's stated pipeline (``reference`` in the configuration file;
``depth_clip`` is true where it is not stated).
"""

from __future__ import annotations

import importlib
from typing import NamedTuple

import torch

from . import precision as P
from . import raster

#: The program's near-plane clipper emits two triangle slots per input
#: triangle (2t, 2t + 1); a triangle wholly in front of w = NEAR_W keeps
#: slot 2t and leaves 2t + 1 degenerate.
NEAR_W = 1e-5


class Frame(NamedTuple):
    tri_id: torch.Tensor  # (S, H, W) int32, the program's id of the winner, -1 where none
    depth_q: torch.Tensor  # (S, H, W) int32
    color: torch.Tensor  # (4, H, W) float32, resolved


def shader(name: str):
    """The reference shader module ``shaders/<name>.py``."""
    return importlib.import_module(f"{__package__}.shaders.{name}")


def scene(name: str):
    """The scene module ``scenes/<name>.py``."""
    return importlib.import_module(f"{__package__}.scenes.{name}")


def scene_instances(sc, seed: int, args: dict, device) -> dict | None:
    """The scene module's instance table, ``sc.instances(seed, args,
    device)``: (I, ...) float32 tensors named as the program's instance
    attributes; None for a scene that defines none and draws its mesh once."""
    fn = getattr(sc, "instances", None)
    return None if fn is None else fn(seed, args, device)


def expand_instances(attrs: dict, instances: dict | None) -> dict:
    """The corner attributes of every instance, instance-major: the mesh's
    corners repeat per instance, and each instance attribute, flattened, is
    repeated per corner."""
    if not instances:
        return attrs
    count = next(iter(instances.values())).shape[0]
    corners = attrs["position"].shape[0]
    out = {k: v.repeat(count, 1) for k, v in attrs.items()}
    for k, v in instances.items():
        out[k] = v.to(torch.float32).reshape(count, -1).repeat_interleave(corners, dim=0)
    return out


def _device_uniforms(uniforms: dict, device) -> dict:
    return {k: torch.as_tensor(v).to(device=device, dtype=torch.float32) for k, v in uniforms.items()}


def clip_space(spec: dict, attrs: dict, uniforms: dict, precision: str = "float32", instances: dict | None = None):
    """(T, 3, 4) clip positions, (T, 3, C) varyings by name, and the
    program's id of each triangle: ``i * T_mesh + k`` for triangle k of
    instance i, doubled under the near clip."""
    dev = attrs["position"].device
    shd = shader(spec["shader"])
    clip, varyings = shd.vertex(expand_instances(attrs, instances), _device_uniforms(uniforms, dev), precision)
    t = clip.shape[0] // 3
    clip = clip.reshape(t, 3, 4)
    varyings = {k: v.reshape(t, 3, -1) for k, v in varyings.items()}
    ids = torch.arange(t, device=dev)
    if spec["near_clip"]:
        if not bool((clip[..., 3] > NEAR_W).all()):
            raise ValueError("a triangle crosses the near plane: the reference does not clip")
        ids = ids * 2
    return clip, varyings, ids


def render(spec: dict, attrs: dict, uniforms: dict, width: int, height: int, msaa: int,
           precision: str = "float32", block: int = 1 << 22, instances: dict | None = None) -> Frame:
    """The frame the configuration states for these inputs."""
    clip, varyings, ids = clip_space(spec, attrs, uniforms, precision, instances)
    samples = raster.MSAA4_OFFSETS if msaa == 4 else raster.CENTER
    vis = raster.rasterize(clip, width, height, samples, spec["cull_mode"], spec["front_face"],
                           depth_clip=spec.get("depth_clip", True))
    dev = clip.device
    shd = shader(spec["shader"])
    u = _device_uniforms(uniforms, dev)
    clear = torch.tensor(spec["clear_color"], dtype=torch.float32, device=dev)
    ns = len(samples)
    color = clear.repeat(ns * height * width, 1)  # (S*H*W, 4)
    tri = vis.tri.reshape(-1)
    bary = vis.bary.reshape(-1, 3)
    won = torch.nonzero(tri >= 0).squeeze(1)
    names = sorted(varyings)
    for lo in range(0, won.numel(), block):
        at = won[lo : lo + block]
        t = tri[at]
        # perspective-correct: sum(b_i a_i / w_i) / sum(b_i / w_i)
        pw = bary[at] / clip[t, :, 3]
        den = pw.sum(dim=1, keepdim=True)
        frag = {k: (pw[:, :, None] * varyings[k][t]).sum(dim=1) / den for k in names}
        rgb = shd.fragment(frag, u)
        color[at] = torch.cat([rgb, torch.ones_like(rgb[:, :1])], dim=1)
    color = color.reshape(ns, height, width, 4).mean(dim=0).permute(2, 0, 1).contiguous()
    tri_id = torch.where(vis.tri >= 0, ids[vis.tri.clamp(min=0)], -1).to(torch.int32)
    return Frame(tri_id, vis.depth_q, color)
