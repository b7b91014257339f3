"""Find where member 0 of the port's batched step leaves the single planet's
bits: the single planet against member 0 of an ensemble of B copies of it,
step by step from the same start, and at the steps that part them, the
calls that do.

    python3 scripts/bisect_member0_torch.py [--nlat 181] [--nlon 360]
                                            [--members 8] [--steps 264]
                                            [--records 6] [--device cuda|cpu]

Builds the flagship planet (every default on, float32) on the device and
steps the single planet (``model.make_step_fn``) and the ensemble of
``--members`` copies of its state (``ensemble.stack_members`` and
``ensemble.run_steps``: the step under ``torch.func.vmap``, mutation
drawing from copies of the model's generator) side by side for ``--steps``
steps (264: phase 4b's warm chunk and day), comparing every leaf's bits
after each step. After a step that parts them, the ensemble starts again
from the single planet's state. The first ``--records`` such steps, each
parting a set of leaves not parted before, run again from the states
before them, each side under a ``TorchFunctionMode`` that records every
PyTorch call with tensor outputs: its name, where in the port it was called, and its inputs and outputs (inside the vmap, member 0's
slice of the physical tensors under the batching). Both sides run the same
Python code, so the calls pair up in order. A call whose inputs are
bit-equal and whose outputs differ adds in another order under the
batching; a first differing call whose inputs differ points at a call the
mode does not see (a kernel's launch). Prints the steps that part, and the
parting calls of each recorded step; the last line is one JSON object.
Imports no JAX.
"""

import argparse
import dataclasses
import json
import os
import sys
import time

import torch
from torch.overrides import TorchFunctionMode

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from qingdai_tpu_torch import ensemble as E  # noqa: E402
from qingdai_tpu_torch import entry  # noqa: E402
from qingdai_tpu_torch import model as M  # noqa: E402

PORT = os.sep + "qingdai_tpu_torch" + os.sep


def _tensors(x):
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _tensors(v)]
    if isinstance(x, dict):
        return [t for v in x.values() for t in _tensors(v)]
    return []


def _physical(t: torch.Tensor) -> torch.Tensor:
    """Member 0's slice of the tensor under any vmap's batching, detached and
    copied."""
    t = t.detach()
    while torch._C._functorch.is_batchedtensor(t):
        bdim = torch._C._functorch.maybe_get_bdim(t)
        t = torch._C._functorch.get_unwrapped(t).select(bdim, 0)
    return t.clone()


def _where() -> str:
    """file:line of the innermost frame in the port."""
    f = sys._getframe(2)
    while f is not None:
        if PORT in f.f_code.co_filename:
            name = f.f_code.co_filename.split(PORT, 1)[1]
            return f"qingdai_tpu_torch/{name}:{f.f_lineno}"
        f = f.f_back
    return "?"


class Recorder(TorchFunctionMode):
    """Records (name, where, inputs, outputs) of every call with a tensor
    output."""

    def __init__(self):
        super().__init__()
        self.calls = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        outs = _tensors(out)
        if outs:
            self.calls.append((getattr(func, "__name__", repr(func)), _where(),
                               [_physical(t) for t in _tensors((args, kwargs))],
                               [_physical(t) for t in outs]))
        return out


def _bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal bit for bit, a size-1 batch axis aside."""
    if a.numel() != b.numel() or a.dtype != b.dtype:
        return False
    a, b = a.reshape(-1), b.reshape(-1)
    if a.is_floating_point():
        ints = {2: torch.int16, 4: torch.int32, 8: torch.int64}[a.element_size()]
        a, b = a.view(ints), b.view(ints)
    return bool(torch.equal(a, b))


def _max_diff(a: torch.Tensor, b: torch.Tensor) -> float:
    if a.numel() != b.numel() or not a.is_floating_point():
        return float("nan")
    return float((a.reshape(-1).double() - b.reshape(-1).double()).abs().max())


def leaf_differences(single, member) -> dict:
    """{group.leaf: max |difference|} of the leaves that differ in their bits."""
    out = {}
    for f in dataclasses.fields(single):
        a, b = getattr(single, f.name), getattr(member, f.name)
        if a is None or not dataclasses.is_dataclass(a):
            continue
        for g in dataclasses.fields(a):
            x, y = getattr(a, g.name), getattr(b, g.name)
            if isinstance(x, torch.Tensor) and not _bits_equal(x, y):
                out[f"{f.name}.{g.name}"] = _max_diff(x, y)
    return out


def culprits(single: list, batched: list) -> list:
    """The calls that part the two steps (module docstring): paired calls
    whose inputs are bit-equal and whose outputs differ, one entry a place
    in the port with its first call index, its count and its largest
    |difference|. Calls pair by name and place, in order (``difflib``): the
    vmap adds calls of its own, such as ``custom_function_call`` around a
    ``torch.autograd.Function``. Where the first differing call had inputs
    that differ, the difference came from a call the mode does not see; that
    call is listed with ``inputs_bit_equal`` false."""
    import difflib
    keys = [[c[:2] for c in calls] for calls in (single, batched)]
    blocks = difflib.SequenceMatcher(None, *keys, autojunk=False).get_matching_blocks()
    found, first = {}, True
    for i, j, n in blocks:
        for k in range(n):
            s, b = single[i + k], batched[j + k]
            if len(s[3]) == len(b[3]) and all(_bits_equal(x, y) for x, y in zip(s[3], b[3])):
                continue
            same_in = len(s[2]) == len(b[2]) and all(_bits_equal(x, y)
                                                     for x, y in zip(s[2], b[2]))
            if same_in or first:
                hit = found.setdefault(s[1], {"call": s[0], "where": s[1], "index": i + k,
                                              "inputs_bit_equal": same_in, "count": 0,
                                              "max_abs_diff": 0.0,
                                              "shapes": [list(x.shape) for x in s[2]]})
                hit["count"] += 1
                hit["max_abs_diff"] = max(hit["max_abs_diff"], max(
                    (_max_diff(x, y) for x, y in zip(s[3], b[3])), default=0.0))
            first = False
    return list(found.values())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--nlat", type=int, default=181)
    ap.add_argument("--nlon", type=int, default=360)
    ap.add_argument("--members", type=int, default=8)
    ap.add_argument("--steps", type=int, default=264)
    ap.add_argument("--records", type=int, default=6,
                    help="how many parting steps to record call by call")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    mdl, st = entry.build_world(args.nlat, args.nlon, device=args.device)
    gens = [torch.Generator(device=mdl.device) for _ in range(args.members)]

    def resync(state):
        """The ensemble of ``--members`` copies of ``state``, its generators
        at the model's state."""
        for g in gens:
            g.set_state(mdl.generator.get_state())
        return E.stack_members([state] * args.members)

    step = M.make_step_fn(mdl)
    ens = resync(st)
    parted, recorded, seen = [], [], set()
    for k in range(args.steps):
        before = (mdl.generator.get_state(), [g.get_state() for g in gens])
        s1, _ = step(st)
        e1, _ = E.run_steps(mdl, ens, 1, 1, step, step, gens)
        leaves = leaf_differences(s1, E.member_state(e1, 0))
        if leaves:
            parted.append(k + 1)
            if len(recorded) < args.records and frozenset(leaves) not in seen:
                seen.add(frozenset(leaves))
                # that step again, recorded, from the states before it
                mdl.generator.set_state(before[0])
                for g, b in zip(gens, before[1]):
                    g.set_state(b)
                with Recorder() as rec_s:
                    step(st)
                with Recorder() as rec_b:
                    E.run_steps(mdl, ens, 1, 1, step, step, gens)
                recorded.append({"step": k + 1, "leaves": leaves,
                                 "culprits": culprits(rec_s.calls, rec_b.calls)})
            e1 = resync(s1)
        st, ens = s1, e1
    device = str(mdl.device)
    if mdl.device.type == "cuda":
        device += f" ({torch.cuda.get_device_name(mdl.device)})"
    print(f"bisect {args.nlat}x{args.nlon} float32 on {device}, B = {args.members}: "
          f"{len(parted)} of {args.steps} steps part member 0 from the single planet"
          + (f" (first after step {parted[0]})" if parted else ""))
    for r in recorded:
        print(f"step {r['step']}: leaves {r['leaves']}; calls that part them: "
              + "; ".join(f"{c['call']} at {c['where']} ×{c['count']} (inputs bit-equal "
                          f"{c['inputs_bit_equal']}, max|diff| {c['max_abs_diff']:.3e}, "
                          f"inputs {c['shapes']})" for c in r["culprits"]))
    print(json.dumps({"members": args.members, "steps": args.steps, "parted": parted,
                      "recorded": recorded, "seconds": time.perf_counter() - t0},
                     default=str))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
