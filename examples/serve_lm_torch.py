"""End-to-end driver #3 on the port: autoregressive LM decode through the
COMPILED serving stack.

The counterpart of ``examples/serve_lm.py`` on ``repro_torch``, with the
same flags (plus ``--device``) and the same final check:

  * every linear is an int8 accelerator matmul (weights staged once as
    graph constants), attention is a host segment, and the KV caches
    live in **persistent** DRAM buffers at stable addresses;
  * one compiled program is one decode STEP, and each concurrent
    dialogue is one ``DevicePool`` session — the scheduler swaps each
    session's KV bytes in and out of its slot and gangs same-step
    accelerator segments across slots;
  * decode is fully autoregressive: the next embedding is chosen by
    greedy argmax over the program's own logits, so one wrong byte
    anywhere derails the whole token sequence — the final check is that
    every pooled dialogue reproduces the eager reference's tokens
    exactly.

The engine is the port's CUDA engine (``--backend cuda``, the
hand-written kernels on the card; their plain versions where the DRAM
image lies on the CPU) or the simulator.

Run:  PYTHONPATH=src python examples/serve_lm_torch.py --sessions 4 \\
          --steps 24 [--device cpu]
Without ``--device`` it runs on the card.
"""
import argparse
import time

import numpy as np

from repro_torch.core.serve import DevicePool
from repro_torch.models.vta_decoder import DecoderConfig, QuantDecoder


def greedy_decode_reference(dec: QuantDecoder, prompt_tok: int,
                            steps: int) -> list:
    """Eager oracle: one dialogue, greedy argmax feedback."""
    ref = dec.reference()
    tok, out = prompt_tok, []
    for _ in range(steps):
        logits = ref.step(dec.token(tok))
        tok = int(np.argmax(logits))
        out.append(tok)
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--sessions", type=int, default=4)
    ap.add_argument("--steps", type=int, default=24)
    ap.add_argument("--pool", type=int, default=2)
    ap.add_argument("--blocks", type=int, default=2)
    ap.add_argument("--backend", default="cuda",
                    choices=["cuda", "simulator"])
    ap.add_argument("--device", default="cuda",
                    help="torch device of the DRAM images (default: the "
                         "card)")
    args = ap.parse_args(argv)

    cfg = DecoderConfig(n_blocks=args.blocks,
                        s_max=max(96, args.steps + 8))
    dec = QuantDecoder(cfg, torch_device=args.device)
    compiled = dec.compile()
    print(f"decoder: {cfg.n_blocks} blocks, d={cfg.d_model}, "
          f"vocab={cfg.vocab}, {compiled.persistent_bytes} persistent "
          f"B/session (KV caches at stable DRAM addresses) on {args.device}")

    prompts = [7 * i + 3 for i in range(args.sessions)]
    want = [greedy_decode_reference(dec, p, args.steps) for p in prompts]

    with DevicePool(compiled, size=args.pool, backend=args.backend) as pool:
        sess = [pool.session() for _ in range(args.sessions)]
        toks = list(prompts)
        decoded = [[] for _ in range(args.sessions)]
        t0 = time.perf_counter()
        for _ in range(args.steps):
            # lockstep round: same-step sessions gang their accel segments
            futs = [s.submit(x=dec.token(t)) for s, t in zip(sess, toks)]
            for i, fut in enumerate(futs):
                nxt = int(np.argmax(fut.wait(timeout=300)))
                decoded[i].append(nxt)
                toks[i] = nxt
        dt = time.perf_counter() - t0
        gangs = sum(s.ganged_steps for s in pool.slot_stats())
        print(f"served {args.sessions} dialogues x {args.steps} greedy "
              f"steps on {len(pool)} slots in {dt:.2f}s "
              f"({args.sessions * args.steps / dt:.1f} steps/s agg, "
              f"{gangs} ganged segments)")
        print("\n".join(pool.describe().splitlines()[1:]))

    for i, (got, ref) in enumerate(zip(decoded, want)):
        assert got == ref, (f"dialogue {i} diverged from the eager "
                            f"reference: {got} vs {ref}")
    print("all pooled dialogues reproduce the eager numpy reference's "
          "greedy tokens exactly:")
    for i, seq in enumerate(decoded):
        print(f"  dialogue {i} (prompt {prompts[i]:>3}): "
              + " ".join(f"{t:>2}" for t in seq))


if __name__ == "__main__":
    main()
