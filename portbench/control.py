"""The control of a cell: the plain reference put in the program's place and
computed one precision below the configuration's (Dense operands in float8
e4m3, TF32 for the float32 products), judged by the cell's own check
against the float32 reference. It has to come out not correct. The
benchmark's runs never run it. Each driver module,
``harness/drivers/<kind>.py``, holds its kind's ``Control``.

    python portbench/control.py --workload <name> --seeds <n> <n> <n> [--seconds 4]
        [--reading control|program|fault:<name>]

Prints, per seed, each compared number beside the cell's limit. With
``--reading program`` the numbers are the program's own (the lower reading
of a limit), with ``fault:<name>`` the program's with that fault of
``faults.py`` planted; a training cell reads them from its set-up's first
steps, without a window, many seeds to one process.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parent))

from portbench import faults  # noqa: E402
from portbench.harness import driver as base  # noqa: E402
from portbench.harness import program  # noqa: E402


def control(cfg: dict, mix: dict, seed: int, seconds: float, device) -> tuple[dict, list]:
    """The cell's numbers with the control in the program's place."""
    program.reference(cfg).set_fp32()
    driver = base.load(mix["kind"]).Control(cfg, mix, seed, device)
    driver.setup()
    if driver.checks_window:
        driver.run_window(seconds)
    driver.free()
    return driver.check()


def program_reading(cfg: dict, mix: dict, seed: int, seconds: float, device,
                    fault: str | None = None) -> tuple[dict, list]:
    """The cell's numbers from the program itself, sound or with ``fault``
    (a function of ``faults.py``) planted: a training cell's first steps
    need no window, the others run a short one."""
    program.reference(cfg).set_fp32()
    planted = getattr(faults, fault)() if fault else contextlib.nullcontext()
    with planted:
        driver = base.load(mix["kind"]).Driver(cfg, mix, seed, device)
        driver.setup()
        if driver.checks_window:
            driver.run_window(seconds)
        driver.free()
    return driver.check()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--reading", default="control",
                    help="control, program, or fault:<name> of faults.py")
    args = ap.parse_args(argv)
    bench = json.loads((HERE.parent / "BENCHMARK.json").read_text())
    wl = next(w for w in bench["workloads"] if w["name"] == args.workload)
    mix = json.loads((HERE / "traffic" / f"{wl['traffic']}.json").read_text())
    limits = json.loads((HERE / "limits" / f"{wl['name']}.json").read_text())["limits"]
    cfg = program.load_config(wl["config"])
    dev = torch.device("cuda", 0)
    for seed in args.seeds:
        if args.reading == "control":
            worst, _ = control(cfg, mix, seed, args.seconds, dev)
        else:
            fault = args.reading.removeprefix("fault:") if args.reading != "program" else None
            worst, _ = program_reading(cfg, mix, seed, args.seconds, dev, fault)
        print(json.dumps({"workload": wl["name"], "reading": args.reading, "seed": seed,
                          "numbers": worst, "limits": limits,
                          "fails": [k for k in limits if not worst[k] <= limits[k]]}),
              flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
