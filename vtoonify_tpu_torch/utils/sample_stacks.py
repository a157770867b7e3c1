"""Where a long script spends its wall time: runs a Python script under a
stack sampler and writes, for its main thread, the seconds spent inside each
function (inclusive), on each innermost line, and on each call chain.

    python -m vtoonify_tpu_torch.utils.sample_stacks OUT_DIR script.py [ARGS...]

Every `interval` seconds a daemon thread reads the main thread's stack and
credits the time since its last reading to it. Time spent in C code that
holds the GIL is credited late, to the stack the sampler sees next. The
tables are written to OUT_DIR (`inclusive.txt`, `lines.txt`, `chains.txt`)
every minute and when the script ends, exceptions and SystemExit included.
Child processes are not sampled.
"""

from __future__ import annotations

import collections
import os
import runpy
import sys
import threading
import time

# the frames of these files make up a call chain's key (chains.txt)
CHAIN_FILES = ("chip_smoke.py",)
CHAIN_PACKAGE = f"{os.sep}vtoonify_tpu_torch{os.sep}"


class Sampler:
    def __init__(self, out_dir: str, interval: float = 0.05):
        self.out_dir = os.path.abspath(out_dir)
        self.interval = interval
        self.main_id = threading.main_thread().ident
        self.inclusive = collections.Counter()
        self.lines = collections.Counter()
        self.chains = collections.Counter()
        self.lock = threading.Lock()

    @staticmethod
    def _key(frame) -> str:
        code = frame.f_code
        return f"{os.path.basename(code.co_filename)}:{code.co_name}:{code.co_firstlineno}"

    def _sample(self, dt: float) -> None:
        frame = sys._current_frames().get(self.main_id)
        if frame is None:
            return
        line = f"{self._key(frame)}@{frame.f_lineno}"
        keys, chain = [], []
        while frame is not None:
            key = self._key(frame)
            keys.append(key)
            path = frame.f_code.co_filename
            if os.path.basename(path) in CHAIN_FILES or CHAIN_PACKAGE in path:
                chain.append(key)
            frame = frame.f_back
        with self.lock:
            for key in set(keys):
                self.inclusive[key] += dt
            self.lines[line] += dt
            self.chains[" <- ".join(chain[:10])] += dt

    def _run(self) -> None:
        last = last_dump = time.perf_counter()
        while True:
            time.sleep(self.interval)
            now = time.perf_counter()
            self._sample(now - last)
            last = now
            if now - last_dump > 60:
                self.dump()
                last_dump = now

    def start(self) -> None:
        threading.Thread(target=self._run, daemon=True).start()

    def dump(self) -> None:
        os.makedirs(self.out_dir, exist_ok=True)
        with self.lock:
            for name, table, top in (("inclusive", self.inclusive, 400),
                                     ("lines", self.lines, 300),
                                     ("chains", self.chains, 400)):
                with open(os.path.join(self.out_dir, f"{name}.txt"), "w") as f:
                    f.writelines(f"{s:9.2f} {k}\n" for k, s in table.most_common(top))


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) < 2:
        raise SystemExit("usage: python -m vtoonify_tpu_torch.utils.sample_stacks "
                         "OUT_DIR script.py [ARGS...]")
    out_dir, script, args = argv[0], argv[1], argv[2:]
    sampler = Sampler(out_dir)
    sampler.start()
    sys.argv = [script, *args]
    try:
        runpy.run_path(script, run_name="__main__")
    finally:
        sampler.dump()


if __name__ == "__main__":
    main()
