"""vtoonify_tpu_torch/utils/sample_stacks.py: a script run under the stack
sampler keeps its arguments and exit code, and its wall time is credited to
the functions and lines that spent it."""

import subprocess
import sys
from pathlib import Path

SCRIPT = """
import sys, time

def spin(s):
    t = time.perf_counter()
    while time.perf_counter() - t < s:
        pass

def nap(s):
    time.sleep(s)

spin(0.6)
nap(0.4)
print(sys.argv[1:])
raise SystemExit(3)
"""


def _table(path):
    out = {}
    for line in Path(path).read_text().splitlines():
        secs, key = line.split(maxsplit=1)
        out[key] = float(secs)
    return out


def test_sample_stacks_credits_functions_and_lines(tmp_path):
    script = tmp_path / "work.py"
    script.write_text(SCRIPT)
    out = tmp_path / "out"
    res = subprocess.run([sys.executable, "-m", "vtoonify_tpu_torch.utils.sample_stacks",
                          str(out), str(script), "a", "b"], capture_output=True, text=True,
                         cwd=Path(__file__).resolve().parents[1])
    assert res.returncode == 3, res.stderr
    assert res.stdout.strip() == "['a', 'b']"
    inclusive = _table(out / "inclusive.txt")
    spin = next(v for k, v in inclusive.items() if k.startswith("work.py:spin:"))
    nap = next(v for k, v in inclusive.items() if k.startswith("work.py:nap:"))
    assert 0.4 <= spin <= 1.2 and 0.25 <= nap <= 0.8, inclusive
    assert any(k.startswith("work.py:spin:") for k in _table(out / "lines.txt"))
