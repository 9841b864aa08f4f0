"""Time two checkouts of favae_tpu_torch on one card, in turns.

    python -m favae_tpu_torch.cli.compare_turns OLD_DIR NEW_DIR [--out FILE]

Each turn is a fresh process whose working directory is one checkout (so it
builds and loads that checkout's kernels): `chip_smoke.serve_slice()`
(`cli.generate` at cat_celebahq through its engines, ms a token from CUDA
events), `chip_smoke.check_decode_step()` (the whole-step kernel at
gpt2_medium, `device_ms` from a replayed CUDA graph) and `matmul_int8` on
seeded inputs at the four CAT projection shapes. The turns run OLD, NEW,
NEW, OLD; the script prints one JSON line a turn and a last line that says
whether `matmul_int8` gave the same bits in both checkouts, and writes all
of it to FILE (default output/turns.json).
"""

import argparse
import json
import pathlib
import subprocess
import sys

TURN = r'''
import json, sys, torch, numpy as np
import chip_smoke as cs
from favae_tpu_torch.ops import int8_matmul as im
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
out = {"tree": sys.argv[1], "card": cs.nvidia_smi()}
runs, launches = cs.serve_slice()
out["serve"] = {name: {k: r[k] for k in ("ms_per_token", "first_token_ms",
                                         "tokens_per_s", "launches")}
                for name, r in runs.items()}
step = cs.check_decode_step()
out["decode_step"] = {k: step[k] for k in ("device_ms", "ms", "max_abs_err")}
bits = []
for i, (k, n) in enumerate([(1536, 1024), (1024, 1536), (1536, 6144),
                            (6144, 1536)]):
    rng = np.random.RandomState(20 + i)
    x = torch.from_numpy(rng.randn(8, k).astype(np.float32)).cuda().bfloat16()
    w = torch.from_numpy((rng.randn(k, n) * 0.05).astype(np.float32)).cuda()
    wq, scale = im.quantize_weight(w)
    bits.append(im.matmul_int8(x, wq, scale).view(torch.int16).cpu())
torch.save(bits, sys.argv[2])
print("TURN " + json.dumps(out), flush=True)
'''


def main(argv=None):
    import torch
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("old")
    ap.add_argument("new")
    ap.add_argument("--out", default="output/turns.json")
    args = ap.parse_args(argv)
    out = pathlib.Path(args.out).resolve()
    out.parent.mkdir(parents=True, exist_ok=True)
    turns, bits = [], {}
    for i, (name, tree) in enumerate((("old", args.old), ("new", args.new),
                                      ("new", args.new), ("old", args.old))):
        path = out.with_name(f"{out.stem}_bits_{i}.pt")
        proc = subprocess.run(
            [sys.executable, "-c", TURN, name, str(path)],
            cwd=pathlib.Path(tree).resolve(), capture_output=True, text=True)
        line = [l for l in proc.stdout.splitlines() if l.startswith("TURN ")]
        if proc.returncode or not line:
            print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
            raise SystemExit(f"turn {i} ({name}) failed")
        turns.append(json.loads(line[0][5:]))
        print(json.dumps(turns[-1]), flush=True)
        bits.setdefault(name, []).append(torch.load(path))
    same = all(torch.equal(a, b) for a, b in zip(bits["old"][0],
                                                 bits["new"][0]))
    result = {"turns": turns, "matmul_int8_same_bits": same}
    out.write_text(json.dumps(result, indent=1))
    print(json.dumps({"matmul_int8_same_bits": same}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
