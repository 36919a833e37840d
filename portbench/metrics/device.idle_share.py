"""device.idle_share.<entry>: the share of the traced slice's wall in
which no kernel, copy or set ran on the device, in percent."""


def read(record):
    t = record["trace"]
    if t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
