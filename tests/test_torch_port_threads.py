"""One intra-op thread for PyTorch in every test process.

The suite runs on several xdist workers that share the machine's cores,
and PyTorch's default (one intra-op thread per core, each spinning
after its op) oversubscribes them: every worker's torch ops and the
JAX references beside them then wait on each other. The port's tests
use small shapes, where one thread loses little. pytest imports every
test module in every worker before any test runs, so this module's
import sets the limit for the whole session; run alone, a port test
file keeps PyTorch's default. Tests that hold two runs bit for bit
compare runs of one process, under one setting.
"""

import torch

PORT_TEST_THREADS = 1
torch.set_num_threads(PORT_TEST_THREADS)


def test_the_session_runs_torch_on_one_intra_op_thread():
    assert torch.get_num_threads() == PORT_TEST_THREADS
