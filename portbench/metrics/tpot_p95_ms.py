"""95th percentile, over every request that finished in the window, of
(finished - first token) / (tokens - 1), both as the benchmark saw them."""
from portbench.stats import percentile


def read(run):
    per = [(tr.done - tr.first) / (tr.req.max_new_tokens - 1) for tr in run.requests
           if tr.done is not None and run.t0 <= tr.done <= run.t1 and tr.req.max_new_tokens > 1]
    return 1e3 * percentile(per, 95) if per else None
