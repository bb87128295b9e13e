"""engine.launches_per_push.stream: device kernels and copies of the traced
window over its pushes."""


def read(rec):
    if len(rec.pushes) == 0 or not rec.device:
        return None
    return sum(len(evs) for evs in rec.device.values()) / len(rec.pushes)
