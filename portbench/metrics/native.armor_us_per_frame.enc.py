"""native.armor_us_per_frame.enc: the frame_pack_batch workers' summed busy time
per frame, in microseconds, for the passes that start inside the encode calls:
the CPU a frame's Reed-Solomon armor, header and CRC cost, whatever the
workers. Reads the pass log that the pipeline fills while its stage timer is
set; None for a program without it."""


def read(rec):
    from frad_python_tpu_torch import native

    calls = [(c.t0, c.t1) for c in rec.calls_of(("encode",))]
    passes = [p for p in getattr(native.frame_pack_batch, "passes", ())
              if any(t0 <= p.t0 < t1 for t0, t1 in calls)]
    frames = sum(p.frames for p in passes)
    return 1e6 * sum(p.busy_s for p in passes) / frames if frames else None
