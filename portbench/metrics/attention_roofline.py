"""attention_roofline: the FLOPs of the attention products (q k^T and the
probabilities times v, 4 N M C a block: the ``attention_flops`` of the
run's configuration's reference module, at each launched image's size,
read from the shapes of the window's ``upsample_argmax`` calls) over the
device time of the attention kernels (by name: the other pump worker's
launches in the same interval are told apart by it) launched inside the
program's ``predict/attention`` spans (lib/launched.py), as a share of the
card's bf16 dense peak, in %. The configuration is the one of the run's
``--workload``. Nothing is read where the program has no such span, or
the configuration's reference has no ``attention_flops``."""
import argparse
import re
import sys

from portbench import reference
from portbench.lib import harness
from portbench.lib.launched import span_device_s

KERNEL = re.compile(r"flash|fmha|sdpa|attention", re.IGNORECASE)


def attention_flops():
    """(model, the reference's ``attention_flops``) of the run's cell, or
    None."""
    p = argparse.ArgumentParser(add_help=False)
    p.add_argument("--workload")
    workload = p.parse_known_args(sys.argv[1:])[0].workload
    if not workload:
        return None
    try:
        config = harness.find_cell(workload).config
        count = getattr(reference.module_for(config), "attention_flops",
                        None)
    except (SystemExit, KeyError, ValueError, OSError):
        return None
    return None if count is None else (config["model"], count)


def read(readings: dict) -> float | None:
    tr, calls = readings.get("trace"), readings.get("upsample_argmax_calls")
    if tr is None or not calls:
        return None
    seconds, events = span_device_s(tr, "predict/attention", KERNEL)
    model = attention_flops()
    if not events or seconds <= 0 or model is None:
        return None
    name, count = model
    work = sum(b * count(name, oh, ow) for b, _f, _wf, oh, ow in calls)
    return work / seconds / readings["peaks"]["bf16_flops_per_s"] * 100.0
