"""Traffic kind ``animated``: a viewer of an animated glTF, one 1080p
frame in flight, closed loop, synchronised.

Frame ``i`` of the window (counter ``base + i``) is one call of the
program, ``RenderPipeline.render(camera, base + i, time=t)``: the scene
posed at ``t = ((base + i) mod P) / R`` seconds (the mix's ``clock``,
the rule that the configuration's scene writes into its file for the
reference), then rendered, with the camera on
the orbit at ``t0 + i * time_step``.  A pair of CUDA events around the
call (pose and render) gives the frame's time.  While the card renders
a frame, the host prepares the next one's camera and gathers the kept
sample, as a viewer does its input, then waits for the frame.  The
check keeps a seeded sample of the frames, each with its counter, from
which the reference poses its own scene.

A program that cannot pose a scene (no ``RenderPipeline.pose``), or
that baked this one without its animation, raises at the warm-up.
"""

from __future__ import annotations

SMALL = {"warmup": 1}


def _posable(client) -> tuple:
    """The mix's clock (period in frames, frames per second), once the
    program is known to pose."""
    pipe = client.pipe
    if not hasattr(pipe, "pose") or getattr(pipe, "animation", None) is None:
        raise RuntimeError("the program does not pose this scene: its "
                           "RenderPipeline has no animation")
    clock = client.tr.mix["clock"]
    return int(clock["period_frames"]), float(clock["frames_per_second"])


def seconds(frame: int, clock: tuple) -> float:
    """The time of frame counter ``frame``: (frame mod P) / R."""
    period, rate = clock
    return (int(frame) % period) / rate


def _camera(client, i: int):
    with client.steps("camera"):
        return client.tr.camera(i, client.cam_type, client.aspect)


def _render(client, clock, cam, i: int):
    frame = client.tr.base + i
    with client.steps("render"):
        return client.pipe.render(
            cam, frame, time=seconds(frame, clock))


def warm_up(client) -> None:
    clock = _posable(client)
    for k in range(int(client.tr.mix.get("warmup", 1))):
        _render(client, clock, _camera(client, k), k)


def loop(client, win, more) -> None:
    tr = client.tr
    clock = _posable(client)
    events = []
    i = win.units
    cam = _camera(client, i)
    while more(win):
        begin, end = client._event(), client._event()
        begin.record()
        image, _ = _render(client, clock, cam, i)
        end.record()
        # The host's share of the next frame while the card renders this
        # one, as a viewer's: its camera, the kept sample's gather.
        with client.steps("keep"):
            tr._reservoir(win.kept, i, lambda: {
                "index": i, "frame": tr.base + i,
                "values": image.reshape(-1, 3)[tr.pix]})
        cam = _camera(client, i + 1)
        client._sync()
        events.append((begin, end))
        win.units += 1
        win.frames += 1
        i = win.units
    win.frame_ms = [b.elapsed_time(e) for b, e in events]
