"""``track_batch``: a call's videos together, one disc a video, over the
traffic's ``mesh`` (``"auto"``: every card the cell has)."""

from portbench import entrykit as kit

positions = kit.positions
reference = kit.one_disc_reference
work = kit.one_disc_work


def caller(port, config, traffic, device, mesh):
    kw = kit.keywords(config, traffic, device)

    def call(clips, videos):
        return port.track_batch(list(clips), start_location=[kit.xy(v.starts[0]) for v in videos],
                                mesh=mesh, **kw)

    return call
