"""engine.push_ms_p95.stream: the 95th percentile, in ms, of the harness's
clock around each `process()` call of the push engines, over every push
of the window."""

import numpy as np


def read(rec):
    if len(rec.pushes) == 0:
        return None
    return float(np.percentile(rec.pushes, 95)) * 1e3
