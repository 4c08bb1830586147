"""``one_torch_thread``: a module-scoped autouse fixture that runs a test
module's PyTorch work on one intra-op thread, and restores the count after.

The port's CPU tests run tiny models, whose operations gain nothing from
PyTorch's intra-op threads; under the suite's parallel workers those
threads' spin-waits take the cores the other workers compute on (a tiny
training run took 33 s alone and 255 s beside five other workers). A test
module applies it by importing it::

    from torch_threads import one_torch_thread  # noqa: F401
"""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
