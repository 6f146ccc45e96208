"""``track_multi``: several animals in one arena, a video's discs tracked
together from one frame stream, each video a call of its own. Its discs'
start rules are all ``xy`` (``start_locations``: each disc's drawn start) or
all ``autodetect`` (``n_targets``: the disc count, ``min_distance`` at its
default). Positions are ``[T, discs, 2]``, the targets in the program's
order: the given starts' or, autodetected, strongest first."""

from portbench import entrykit as kit
from portbench.reference import multi

positions = kit.positions


def targets(video) -> dict:
    """The keyword arguments that name a video's targets."""
    if all(s is None for s in video.starts):
        return {"n_targets": len(video.starts)}
    if any(s is None for s in video.starts):
        raise ValueError("track_multi takes every disc's start or none")
    return {"start_locations": [kit.xy(s) for s in video.starts]}


def caller(port, config, traffic, device, mesh):
    kw = kit.keywords(config, traffic, device)

    def call(clips, videos):
        return [port.track_multi(c, **targets(v), **kw) for c, v in zip(clips, videos)]

    return call


def reference(config, clip_sets, sets, windows=None):
    out = []
    for clips, videos in zip(clip_sets, sets):
        out.append(kit.answers(config, [
            multi.track(c, v.starts, target_width=float(config["target_width"]),
                        window=int(config["window_size"]),
                        darker_target=bool(config["darker_target"]), windows=windows)
            for c, v in zip(clips, videos)]))
    return out


def work(config, videos, out, bounded):
    """For each video: where it autodetects, frame 1's whole-frame response
    (``H x W`` outputs: radii ``(H - 1) / 2`` and ``(W - 1) / 2``; the peaks'
    argmax and suppression are not counted); each target's snap at the
    configured window; one step a target a later frame."""
    H, W = int(config["height"]), int(config["width"])
    r = int(config["window_size"]) // 2
    L = kit.taps_len(config)
    work = []
    for (_, ij), (_, auto) in zip(out, videos):
        lanes = ij.shape[1]
        if auto:
            work.append(dict(radii=((H - 1) / 2, (W - 1) / 2), L=L, T=1, lanes=1))
        work.append(dict(radii=(r, r), L=L, T=1, lanes=lanes))
        work.append(dict(radii=(r, r), L=L, T=len(ij) - 1, bounded=bounded, lanes=lanes))
    return work
