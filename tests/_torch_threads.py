"""The port's CPU test modules run torch on one intra-op thread: each
imports :func:`torch_one_thread`, an autouse fixture."""
import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def torch_one_thread():
    """torch on one intra-op thread for the module, restored after.  The
    suite runs several workers on one host; at these small shapes torch's
    thread pool mostly waits (a reduced jamba forward took 1.2 s on 8
    threads, 0.05 s on one, on an idle host), and under the suite's load a
    module's trainer runs grew to minutes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
