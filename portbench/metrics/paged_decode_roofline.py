"""The paged decode kernel's share of its roofline in the traced window:
the summed least time of its calls (one per attention layer per decode
tick, each reading every active lane's K and V rows once, with q and the
output) over the device time of the kernels this pattern names."""
from portbench.roofline import bound_s, paged_decode_call

KERNEL = r"paged_cluster_kernel"


def read(run):
    tr = run.device_trace
    if tr is None or tr.t1 is None:
        return None
    busy = tr.matching(KERNEL)
    m = run.model
    least = 0.0
    for _n, _a, _b, _t, d in run.spans.named("engine.tick", tr.t0, tr.t1):
        if d is not None:
            nbytes, flops = paged_decode_call([int(p) + 1 for p in d], m["n_heads"],
                                              m["n_kv_heads"], m["head_dim"],
                                              run.cell["engine"]["page_size"])
            least += m["n_layers"] * bound_s(nbytes, flops)[0]
    return 100.0 * least / busy if busy > 0 and least > 0 else None
