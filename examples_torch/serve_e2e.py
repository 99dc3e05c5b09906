"""End-to-end serving on the PyTorch/CUDA port (twin of
``examples/serve_e2e.py``; the paper is serving infrastructure, so the e2e
run is SERVING): the full mamba2-130m — the real 130M-parameter config,
not a smoke variant — served as an among-device query service with
batched requests from NNStreamer-Edge clients.

    PYTHONPATH=src python examples_torch/serve_e2e.py [--requests 8 --gen 16] [--device cpu]

This exercises the whole stack: the model zoo (the SSD decode path, S2 and
S3 on the card), the query protocol (discovery + client-id routing),
batched serving, the broker control plane.
"""
import argparse

from repro_torch.launch import serve


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    ok = serve.main([
        "--arch", "mamba2-130m",            # FULL assigned config (130M)
        "--requests", str(args.requests),
        "--prompt-len", str(args.prompt_len),
        "--gen", str(args.gen),
    ], device=args.device)
    assert ok == args.requests
    print("OK — full mamba2-130m served batched requests end-to-end")
    return {"answered": ok, "requests": args.requests,
            "tokens": args.requests * args.gen}


if __name__ == "__main__":
    main()
