"""``track``: one video a call, one disc in it, from its start or autodetected
in the quarter-frame window about the centre."""

from portbench import entrykit as kit

positions = kit.positions
reference = kit.one_disc_reference
work = kit.one_disc_work


def caller(port, config, traffic, device, mesh):
    kw = kit.keywords(config, traffic, device)

    def call(clips, videos):
        return [port.track(clips[0], start_location=kit.xy(videos[0].starts[0]), **kw)]

    return call
