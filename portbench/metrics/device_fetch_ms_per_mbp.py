"""The device stage's blocking device-to-host copies of each batch's payload
and wide chain rows, the wait for the card inside the device timer (the
engine's device_fetch timer), summed over the window's map_file calls, in
ms a read Mbp (engine timers, host clock)."""

TIMERS = ("device_fetch",)


def read(rec):
    t = rec["timers"]
    if rec["read_mbp"] <= 0 or not any(k in t for k in TIMERS):
        return None
    return 1000.0 * sum(t.get(k, 0.0) for k in TIMERS) / rec["read_mbp"]
