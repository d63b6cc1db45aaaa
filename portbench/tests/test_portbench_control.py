"""The correctness check's control: the plain reference with every bf16
matrix rounded to float8 e4m3 reads a wider gap than the program does.
On the CPU at the tiny size; on the card (``gpu``) at each cell's own size,
where it has to cross the cell's limit that the program stays under."""
import pytest

from portbench import harness
from portbench.control import read


@pytest.mark.parametrize("cell", ["dsmoe-chat", "glm-longdoc", "dsmoe-chat-over"])
def test_control_reads_wider_than_the_program_on_the_cpu(tiny_run, cell):
    run = tiny_run(cell, seconds=3.0, seed=2**31 + 99)
    run.cell["correctness"]["sample"] = 10_000
    program, control = read(run)
    program = program["checks"]["mean_logit_gap"]["value"]
    control = control["checks"]["mean_logit_gap"]["value"]
    assert control > 3 * program, (program, control)


@pytest.mark.gpu
@pytest.mark.parametrize("cell,seconds", [("dsmoe-apps", 20), ("dsmoe-chat", 45),
                                          ("glm-longdoc", 45), ("dsmoe-chat-over", 45)])
def test_control_fails_and_the_program_passes_on_the_card(cell, seconds):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    harness.prepare_env()
    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    run = harness.Run(bench, cell, 2**31 + 4242, seconds, False, "cuda:0")
    program, control = read(run)
    print(cell, program["checks"], control["checks"])
    assert program["correct"], program["checks"]
    assert not control["correct"], control["checks"]
