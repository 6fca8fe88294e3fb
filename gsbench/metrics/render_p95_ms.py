"""The 95th percentile of every view's latency in the window: from a CUDA
event recorded at its issue on the idle stream to one recorded after it,
read on the device's clock."""

import numpy as np


def read(out):
    if out.kind != "render" or not out.latencies_ms:
        return None
    return float(np.percentile(out.latencies_ms, 95))
