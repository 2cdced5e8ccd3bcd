"""A run with the timed path broken underneath comes out not correct:
once for each fault a cell can have.  (No cell spans cards, so no
exchange between cards can be left out.)"""

from __future__ import annotations

import pytest
import torch

from vulkan_pathtracer_tpu_torch.render import pipeline, wavefront

CELLS = ("atrium-flat.orbit", "atrium-tlas.orbit", "atrium-flat.still",
         "atrium-flat.flythrough")


def state_unchanged(monkeypatch):
    """The bounce step returns the path's state as it came in."""
    def unchanged(shading, hit_point, origin, direction, atten, seed_x,
                  seed_y, did_hit, rr):
        return origin, direction, atten, seed_x, seed_y, did_hit
    monkeypatch.setattr(wavefront, "_next_segment", unchanged)


def half_left_out(monkeypatch):
    """Half of each batch is traced and the rest takes its mean: half of
    a frame's rows, half of a joint batch's frames, half of a pooled
    group's cameras."""
    render = pipeline.RenderPipeline.render
    batch_sum = pipeline.RenderPipeline.render_batch_sum
    pooled = pipeline.RenderPipeline.render_pooled

    def half_rows(self, camera, frame, present_order=True):
        image, rays = render(self, camera, frame, present_order)
        image = image.clone()
        image[1::2] = image[0:image.shape[0] - 1:2]
        return image, rays

    def half_frames(self, camera, frame0, batch, joint=None):
        total, rays = batch_sum(self, camera, frame0, max(batch // 2, 1),
                                joint)
        return total * (batch / max(batch // 2, 1)), rays

    def half_cameras(self, cameras, frames):
        half = max(len(cameras) // 2, 1)
        images, rays = pooled(self, cameras[:half], frames[:half])
        index = torch.arange(len(cameras)) % half
        return images[index.to(images.device)], rays

    monkeypatch.setattr(pipeline.RenderPipeline, "render", half_rows)
    monkeypatch.setattr(pipeline.RenderPipeline, "render_batch_sum",
                        half_frames)
    monkeypatch.setattr(pipeline.RenderPipeline, "render_pooled",
                        half_cameras)


def answer_altered(monkeypatch):
    """The sky's radiance altered where it is produced, by 2^-8."""
    sky = wavefront.sky_color
    monkeypatch.setattr(wavefront, "sky_color",
                        lambda direction: sky(direction) * (1.0 + 2.0**-8))


@pytest.mark.parametrize("fault", [state_unchanged, half_left_out,
                                   answer_altered])
@pytest.mark.parametrize("workload", CELLS)
def test_a_broken_path_is_not_correct(small_run, monkeypatch, workload,
                                      fault):
    fault(monkeypatch)
    line = small_run(workload)
    assert line["correct"] is False
    off = line["checks"]["pixels_off"]
    assert off["value"] > off["limit"]


@pytest.mark.parametrize("workload", CELLS)
def test_the_sound_path_is_correct(small_run, workload):
    line = small_run(workload)
    assert line["correct"] is True
    assert line["checks"]["pixels_off"]["value"] == 0.0
