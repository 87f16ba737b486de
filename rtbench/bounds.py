"""The spreads that the end-to-end bounds are set from.

    python3 rtbench/bounds.py SET1 SET2 [SET1 SET2 ...]

Each argument is a file of result lines (the last line of each run's
standard output, one run a line) of one set of runs of one cell; the files
come in pairs, the two sets of a cell run on the same seeds. For each cell
and metric it prints each set's median and spread (the distance between
the first and the third quartile, statistics.quantiles with n=4, over the
median) and five times the wider spread, the bound that the rule of five
gives; beside them the two readings a check takes of a bound: the mean of
the two sets' spreads with each set's run farthest from its median left
out (a bound under twice it is too tight), and the spread of all the runs
together (a bound over eight times it is too loose). Then, for each
metric, the widest of each over the cells."""

import json
import statistics
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from rtbench.harness.common import spread  # noqa: E402


def runs(path):
    return [json.loads(line) for line in Path(path).read_text().splitlines()
            if line.startswith("{")]


def tight(values):
    """The spread of ``values`` with the run farthest from their median
    left out."""
    med = statistics.median(values)
    far = max(range(len(values)), key=lambda i: abs(values[i] - med))
    return spread([v for i, v in enumerate(values) if i != far])


def main(paths):
    widest, tights, alls = {}, {}, {}
    for a, b in zip(paths[::2], paths[1::2]):
        sets = [runs(a), runs(b)]
        for name in sets[0][0]["metrics"]:
            vals = [[r["metrics"][name]["value"] for r in s] for s in sets]
            sp = [spread(v) for v in vals]
            med = [statistics.median(v) for v in vals]
            t = statistics.mean(tight(v) for v in vals)
            al = spread(vals[0] + vals[1])
            print(f"{a} | {b}: {name} medians {med} spreads {sp} "
                  f"five times the wider {5 * max(sp)!r}; farthest left "
                  f"out {t!r}, all runs {al!r}")
            widest[name] = max(widest.get(name, 0.0), max(sp))
            tights[name] = max(tights.get(name, 0.0), t)
            alls[name] = max(alls.get(name, 0.0), al)
    for name, sp in widest.items():
        print(f"{name}: widest spread {sp!r}, five times {5 * sp!r}; "
              f"farthest left out {tights[name]!r}, all runs {alls[name]!r}")


if __name__ == "__main__":
    main(sys.argv[1:])
