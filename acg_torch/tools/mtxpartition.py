"""``mtxpartition``: offline graph partitioning.

The port of ``acg_tpu/tools/mtxpartition.py`` (reference
mtxpartition/mtxpartition.c: read a matrix, partition it into --parts=N
with an optional --seed, write the part vector as a Matrix Market integer
array, usage :258-281).  ``python -m acg_torch.cli A.mtx --nparts N
--partition FILE`` reads the vector back, so repeated solves skip
partitioning.  Runs on the host; no device is needed.

Run: ``python -m acg_torch.tools.mtxpartition A.mtx --parts 8 -o A.part.mtx``
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from acg_torch.io.mtxfile import MtxFile, read_mtx, write_mtx
from acg_torch.partition.partitioner import edge_cut, partition_graph
from acg_torch.sparse.csr import csr_from_mtx


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="mtxpartition",
        description="Partition a Matrix Market matrix for distributed "
                    "solves; writes the part vector as a Matrix Market "
                    "integer array.")
    p.add_argument("A", help="Matrix Market file")
    p.add_argument("--parts", type=int, required=True, metavar="N",
                   help="number of parts")
    p.add_argument("--method", default="auto",
                   choices=["auto", "chunk", "rb", "bfs", "kway"])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--binary", action="store_true",
                   help="read the matrix in binary format")
    p.add_argument("-o", "--output", default=None,
                   help="output file [stdout]")
    p.add_argument("-v", "--verbose", action="store_true")
    args = p.parse_args(argv)

    from acg_torch.errors import run_main
    return run_main(lambda: _run(args))


def _run(args) -> int:
    A = csr_from_mtx(read_mtx(args.A, binary=args.binary or None))
    part = partition_graph(A, args.parts, method=args.method, seed=args.seed)
    if args.verbose:
        counts = np.bincount(part, minlength=args.parts)
        print(f"edge cut: {edge_cut(A, part)}; part sizes: "
              f"min {counts.min()} max {counts.max()}", file=sys.stderr)
    m = MtxFile(object="vector", format="array", field="integer",
                nrows=len(part), ncols=1, nnz=len(part),
                vals=part.astype(np.float64))
    if args.output:
        write_mtx(args.output, m)
    else:
        sys.stdout.write("%%MatrixMarket vector array integer general\n")
        sys.stdout.write(f"{len(part)}\n")
        for v in part:
            sys.stdout.write(f"{int(v)}\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
