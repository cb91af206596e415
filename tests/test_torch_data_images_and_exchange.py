"""The JAX package's ``tests/data/test_images_and_exchange.py`` bodies
on the port (loaded by ``tests/test_torch_runtime_loader.py``):
``read_images`` (resize, mode, packing small files into blocks) and the
pipelined exchanges (shuffle, sort, repartition), and puts and a shuffle
past the store's budget in a subprocess. Every body is loaded; the four
``slow`` ones run with ``-m slow``."""

from test_torch_runtime_loader import FIXTURES, load_core_tests, ray_session

globals().update(FIXTURES)
globals().update(load_core_tests("data/test_images_and_exchange.py"))
globals()["ray_session"] = ray_session
