"""Device-to-host pulls a round on the scan driver: the server's own
``host_syncs`` counter over the window's rounds."""


def read(o):
    rounds = o.counters.get("rounds")
    if not rounds or "host_syncs" not in o.counters:
        return None
    return o.counters["host_syncs"] / rounds
