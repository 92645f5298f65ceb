"""A whole run, the chip's check skipped, with the timed path broken
underneath: ``correct`` comes out false for each fault a cell can have.

- ``stale``: a step that returns its state unchanged (a frame keeps the
  first frame's uniforms; a sequence call returns the first call's frames);
- ``half``: half of the batch left out (half of the triangles of a frame,
  half of the frames of a sequence call);
- ``altered``: an answer altered where it is produced (one pixel of each
  frame's colour).
The cells run on one chip: there is no exchange between chips to leave out.
"""

import pytest
import torch

from benchmark.conftest import SMALL
from benchmark.harness import core, spec


def _stale_frames(monkeypatch):
    from based_renderer_tpu_torch import renderer as R

    load = R._Slot.load

    def stale(self, x):
        if self.src is None:
            load(self, x)

    monkeypatch.setattr(R._Slot, "load", stale)


def _half_triangles(monkeypatch):
    from based_renderer_tpu_torch import renderer as R
    from based_renderer_tpu_torch.scene import Mesh

    render_frame = R.Renderer.render_frame

    def half(self, pipeline, mesh, uniforms=None, instances=None, **kw):
        n = mesh.attributes["position"].shape[0] // 6 * 3
        mesh = Mesh(attributes={k: v[:n] for k, v in mesh.attributes.items()}, indices=None)
        return render_frame(self, pipeline, mesh, uniforms, instances, **kw)

    monkeypatch.setattr(R.Renderer, "render_frame", half)


def _altered_frame(monkeypatch):
    from based_renderer_tpu_torch import renderer as R

    render_frame = R.Renderer.render_frame

    def altered(self, *a, **kw):
        f = render_frame(self, *a, **kw)
        f.color_planar[:, 3, 5] += 0.25
        return f

    monkeypatch.setattr(R.Renderer, "render_frame", altered)


def _wrap_sequence(monkeypatch, edit):
    from based_renderer_tpu_torch import renderer as R

    seq = R.Renderer.render_sequence

    def wrapped(self, *a, **kw):
        sums, colors = seq(self, *a, **kw)
        edit(colors)
        return sums, colors

    monkeypatch.setattr(R.Renderer, "render_sequence", wrapped)


def _stale_sequence(monkeypatch):
    first = []

    def stale(c):  # every call returns the first call's frames
        if first:
            c.copy_(first[0])
        else:
            first.append(c.clone())

    _wrap_sequence(monkeypatch, stale)


def _half_sequence(monkeypatch):
    def half(c):
        c[c.shape[0] // 2:] = torch.tensor([0.0, 0.0, 0.0, 1.0])[:, None, None]

    _wrap_sequence(monkeypatch, half)


def _altered_sequence(monkeypatch):
    def alter(c):
        c[:, :, 3, 5] += 0.25

    _wrap_sequence(monkeypatch, alter)


PRESENT = {"stale": _stale_frames, "half": _half_triangles, "altered": _altered_frame}
SEQUENCE = {"stale": _stale_sequence, "half": _half_sequence, "altered": _altered_sequence}
CASES = [("cube_1080p.present", k, f) for k, f in PRESENT.items()] + [
    (w, k, f) for w in ("cube_1080p.sequence", "big_mesh_4k_msaa4.sequence") for k, f in SEQUENCE.items()]


def _run(bench, workload, seconds=1.5):
    cfg = spec.cell(bench, workload)["config"]
    return core.run(bench, workload, 2**31 + 77, seconds, False, "cpu", core.time.perf_counter(),
                    overrides=SMALL[cfg])


@pytest.mark.parametrize("workload", ["cube_1080p.present", "cube_1080p.sequence", "big_mesh_4k_msaa4.sequence"])
def test_a_sound_run_is_correct(bench, workload):
    r = _run(bench, workload, 3.0 if workload.startswith("big_mesh") else 1.5)
    assert r.correct, r.checks


@pytest.mark.parametrize("workload, fault, plant", CASES, ids=[f"{w}-{k}" for w, k, _ in CASES])
def test_a_fault_makes_the_run_incorrect(bench, monkeypatch, workload, fault, plant):
    plant(monkeypatch)
    r = _run(bench, workload, 3.0 if workload.startswith("big_mesh") else 1.5)
    assert not r.correct, (fault, r.checks)
