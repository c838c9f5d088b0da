"""Batched serving example: prefill + KV-cache decode.

    PYTHONPATH=src python -m repro_torch.examples.serve_lm [--arch tinyllama-1.1b] [--device cpu]

Uses the reduced config; the identical serve path is what the
decode_32k / long_500k dry-run cells trace for the production mesh.  On
the card the prefill's attention runs the flash-attention kernel.
"""
import sys

from repro_torch.launch.serve import main as serve_main


def main(argv=None) -> int:
    return serve_main(["--reduced", "--batch", "4", "--prompt-len", "16",
                       "--new-tokens", "12",
                       *(sys.argv[1:] if argv is None else argv)])


if __name__ == "__main__":
    raise SystemExit(main())
