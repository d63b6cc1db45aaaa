"""The benchmark's own tests: the harness on the CPU at a tiny size, and
(``gpu``) its control on the card.  Run from the checkout's root:
``python -m pytest -q portbench/tests``."""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

# The tiny decoder the CPU tests run every cell on (the cells' own files
# hold the published widths).
TINY = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128, vocab_size=512,
            head_dim=16, n_experts=8, top_k=2, moe_d_ff=32, first_dense_layers=1,
            n_shared_experts=1, param_dtype="bfloat16", compute_dtype="bfloat16")


def shrink(run) -> None:
    """Cut a cell's traffic and engine to what the tiny decoder on the CPU
    runs in seconds; its kind, its strategy and its checks stay."""
    cell = run.cell
    kind = cell["traffic"]["kind"]
    if kind == "open_loop":
        cell["traffic"].update(rate=20, prompt={"median": 20, "sigma": 1.0, "min": 4, "max": 64},
                               output={"median": 6, "sigma": 0.8, "min": 2, "max": 16})
        cell["engine"].update(n_lanes=8, max_prompt_len=64, max_len=96)
        cell["engine"].pop("n_pages", None)
        cell["warmup"]["prompt"] = 64
    elif kind == "closed_loop":
        cell["traffic"].update(clients=6, prompt={"min": 30, "max": 70},
                               output={"min": 8, "max": 20}, max_total=96)
        cell["engine"].update(n_lanes=4, max_prompt_len=128, max_len=128)
        cell["warmup"]["prompt"] = 70
    elif kind == "apps":
        run.model["vocab_size"] = 65536  # the bridge's prompt tokens run to 50020
        cell["engine"].update(n_lanes=8)
        cell["traffic"]["max_new_tokens"] = 4
        cell["traffic"]["programs"] = {"admin_workflow": {"users": [4, 8]},
                                       "user_flow": {"orders": [2, 3], "line_items": [2, 3]},
                                       "rag_pipeline": {"questions": [2, 3], "passages": [2, 3]}}


@pytest.fixture
def tiny_run():
    """``make(cell, seconds, seed)`` → a harness Run of ``cell`` on the CPU
    with the tiny decoder."""
    from portbench import harness

    def make(cell: str, seconds: float = 2.0, seed: int = 2**31 + 12345):
        bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
        over = dict(TINY)
        config = next(w["config"] for w in bench["workloads"] if w["name"] == cell)
        if not harness.load_json(harness.HERE / "configs" / f"{config}.json")["model"].get(
                "n_experts"):
            over.update(n_kv_heads=2, n_experts=0)
        run = harness.Run(bench, cell, seed, seconds, False, "cpu", model_override=over)
        shrink(run)
        return run

    return make
