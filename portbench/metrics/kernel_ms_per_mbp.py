"""The CUDA kernels' summed durations inside the window, from the
benchmark's own torch.profiler trace, in ms a read Mbp."""


def read(rec):
    tr = rec.get("trace")
    if not tr or tr["kernel_s"] <= 0 or rec["read_mbp"] <= 0:
        return None
    return 1000.0 * tr["kernel_s"] / rec["read_mbp"]
