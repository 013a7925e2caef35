"""Per cent of the slowest rank's row rendering by which the fastest
rank's was shorter, a frame, averaged over the traced window's frames:
the `shard_render` spans (device event intervals) of every rank, rank
0's own and the other ranks' that the program's trace fetches through
its frame loop, (slowest - fastest) / slowest in each frame that every
rank's span reaches."""
from gdbench import program_trace


def read(rec):
    tr = program_trace.window(rec)
    if not tr:
        return None
    by_frame = {}
    for s in tr["spans"]:
        if s["name"] == "shard_render" and s["device_ms"] is not None:
            by_frame.setdefault(s["frame"], {})[s["attrs"]["rank"]] = \
                s["device_ms"]
    ranks = max((len(v) for v in by_frame.values()), default=0)
    shares = [(max(v.values()) - min(v.values())) / max(v.values())
              for v in by_frame.values()
              if len(v) == ranks and max(v.values()) > 0]
    if ranks < 2 or not shares:
        return None
    return 100.0 * sum(shares) / len(shares)
