"""UltraNet-INT4 inference through the BSEG packed datapath — the
paper's own evaluation workload (Tabs. II-IV), end to end on the torch
port.

Run:  PYTHONPATH=src python examples_torch/ultranet_bseg.py [--size 64]
      [--device cpu]

One seeded frame (weights from seed 0, the frame from seed 1) goes
through ``ultranet_forward(mode="bseg")`` — on a CUDA card the 3x3
stages run on the BSEG conv2d kernel (B3) and the 1x1 head on the SDV
GEMM (B2); with ``--device cpu`` their plain torch versions — and
through the exact integer conv oracle (``mode="ref"``).  It prints
whether the two agree bit for bit (the exit code is 1 if not), the
route of each conv, the 416x416 multiply counts and the Tab. IV lines
of the resource model.  The work is ``repro_torch.launch.ultranet``'s,
at this example's smaller default frame.
"""
import sys

from repro_torch.launch import ultranet


def main(argv=None):
    return ultranet.main(argv, default_size=64)


if __name__ == "__main__":
    sys.exit(main())
