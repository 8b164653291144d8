"""Shared settings of the port's CPU tests.

Importing this module sets torch to one intra-op thread (the port's
CPU test files import it; ``test_torch_cuda.py`` does not).  Their
tensors are tiny, so torch's default pool of one thread per core buys
nothing, and each op ends in a barrier whose threads spin.  Beside
other test workers (pytest-xdist) and JAX's own thread pool those spins
take the cores from each other: in six concurrent runs of the same two
speculative-decoding tests each took 110 s with the default pool and
21 s with one thread (8-core host).  The setting is per process, so it
holds for every test a worker runs after collecting this module.

``unoptimized_jax_compiles``, imported into a test module, compiles
that module's JAX references without XLA's optimization passes (their
programs are tiny: the passes cost more than they save) and without
the persistent compilation cache, whose reads fail in this suite (each
compile warned, then wrote an entry nothing reads); both settings are
restored after the module.
"""
import jax
import pytest
import torch

torch.set_num_threads(1)


@pytest.fixture(autouse=True, scope="module")
def unoptimized_jax_compiles():
    settings = {"jax_disable_most_optimizations": True,
                "jax_enable_compilation_cache": False}
    was = {k: jax.config.values[k] for k in settings}
    for k, v in settings.items():
        jax.config.update(k, v)
    yield
    for k, v in was.items():
        jax.config.update(k, v)
