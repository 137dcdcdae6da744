"""Build the JAX package's native runtime once, before any test process
collects.

``zlibes_tpu.runtime.native`` compiles ``zscan.cc`` at first use into
``~/.cache/zlibes_tpu/libzscan-<tag>.so`` through one shared temporary
name.  Under ``pytest -n`` every worker reaches that build while it
collects; on an empty cache the workers that lose the race keep no library
for the whole session.  The controlling process builds it here, before it
starts any worker, so that each worker finds the library already there.
"""


def pytest_configure(config):
    if hasattr(config, "workerinput"):
        return
    from zlibes_tpu.runtime import native

    native.available()
