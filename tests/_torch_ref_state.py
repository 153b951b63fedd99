"""The reference's process-wide executable state, as the port's parity
tests see it.

The reference's dispatcher keeps its per-op executables for the whole
process (``paddle_tpu/ops/dispatcher.py:_get_exec``, an ``lru_cache``,
and each schema's ``_fast_ex`` memo). While a persistent executable
store is attached, each of them is wrapped in ``exec_store.
PersistentJit``, whose memo, keyed on shapes and dtypes only, keeps an
executable loaded from disk. Such a loaded executable expects its
arguments on all 8 virtual devices of the test mesh. ``detach()`` drops
the store but not the wrappers, so a later file in the same worker that
runs the reference at the same shapes gets "Expected args to
execute_sharded_on_local_devices to have 8 shards, got: [1, 1]"
(``tests/test_exec_store.py``'s warm starts leave exactly that).

Each port test file that runs the reference's tiny Llama (``FILES``)
imports the module-scoped autouse fixture
``reference_executables_dropped``, which calls
``drop_reference_executables()`` before the file's first test.
"""

import pytest

FILES = ("test_torch_gang_engine", "test_torch_generation_contiguous",
         "test_torch_llama_serving", "test_torch_serving_capture",
         "test_torch_serving_metrics", "test_torch_tracing",
         "test_torch_weight_only_serving")


def drop_reference_executables():
    """Forget the per-op executables the reference's dispatcher holds
    (the ``_get_exec`` cache and the ``_fast_ex`` memos, which hold the
    store's wrappers); the next reference call builds its executable
    afresh. JAX's own compilation caches stay."""
    from paddle_tpu.ops import dispatcher as rdisp
    rdisp._get_exec.cache_clear()
    for schema in rdisp.OPS.values():
        schema.__dict__.pop("_fast_ex", None)


@pytest.fixture(scope="module", autouse=True)
def reference_executables_dropped():
    """Start the importing file from no reference executables: an earlier
    file in the same worker may have left ones loaded from a disk store,
    which refuse the file's single-device arrays."""
    drop_reference_executables()


def plant_loaded_executables(root, fn):
    """Leave the state a warm start leaves: run ``fn()`` with a store at
    ``root`` attached (compiling and saving), drop the in-process
    executables, run it again (loading them from disk), then detach.
    Returns what the second run raised (the first loaded executable
    already refuses single-device arguments), or None."""
    from paddle_tpu.jit import exec_store as es
    es.attach(root)
    try:
        drop_reference_executables()    # wrapped only when built anew
        fn()
        drop_reference_executables()
        try:
            fn()
        except Exception as e:      # noqa: BLE001  (the planted fault)
            return e
        return None
    finally:
        es.detach()
