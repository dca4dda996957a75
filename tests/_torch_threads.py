"""One torch thread for the port's CPU tests at smoke size.

Importing ``one_thread`` into a test module applies it to the whole
module (autouse): torch's intra-op threads are set to 1 before the
module's first fixture and put back after its last test. Smoke-size
tensors gain nothing from more threads, and under several pytest
workers on one machine eight threads a worker only contend with each
other: the same torch work runs several times faster on one.
"""
import pytest

torch = pytest.importorskip("torch")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
