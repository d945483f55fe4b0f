"""Build the native library once, before any test process imports it.

``heatmap_tpu/native.py`` runs ``make -C native`` at import. Under
``pytest -n N`` on a fresh checkout every worker would run it at once,
and the workers share ``native/build/libheatmap_native.so.tmp``: a worker
whose build loses that race imports the module without its library. This
hook runs the build in the controller (or in a plain run) under a lock,
so the workers find the library built. A failed build is ignored: the
tests that need the library skip as before.
"""

import fcntl
import os
import subprocess

_ROOT = os.path.dirname(os.path.abspath(__file__))


def pytest_configure(config):
    if hasattr(config, "workerinput"):
        return
    native = os.path.join(_ROOT, "native")
    if not os.path.isdir(native):
        return
    lock_dir = os.path.join(_ROOT, "build")
    os.makedirs(lock_dir, exist_ok=True)
    with open(os.path.join(lock_dir, ".native-make.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            subprocess.call(["make", "-C", native],
                            stdout=subprocess.DEVNULL,
                            stderr=subprocess.DEVNULL)
        except OSError:
            pass
