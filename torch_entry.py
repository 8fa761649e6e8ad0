"""Entry points of the PyTorch/CUDA port (`manta_tpu_torch`).

- `entry(device="cuda")` returns `(fn, args)`: the port's device-prover core
  (witness -> sparse A/B/C row evaluation -> coset-NTT h(x) -> the four
  MSMs) on a Poseidon-preimage circuit, on the "rns_fused" curve backend
  with window 8 and 16 column steps, the shape of the JAX package's
  `__graft_entry__.entry`. `fn(*args)` returns the four MSM accumulators.
- `dryrun(device="cuda")` proves that circuit once through the same prover
  and verifies the proof with the host pairing; it returns the proof.

    python3 torch_entry.py [--device cpu]

runs `dryrun`. Both default to the card and raise without one; `device="cpu"`
runs the plain versions. A multi-chip dry run waits for the port's
`parallel/` package.
"""

from __future__ import annotations

import argparse
import functools
import random
import sys

BACKEND = "rns_fused"
WINDOW_BITS = 8
COLUMN_STEPS = 16


def _poseidon_preimage_circuit(mode: str, values=None):
    """2-ary Poseidon preimage-knowledge circuit (BN254, production
    parameters): the witness-side gadget of every MantaPay shape."""
    from manta_tpu_torch import fields
    from manta_tpu_torch.models import circuit as CC
    from manta_tpu_torch.utils import grain

    fr = fields.BN254_FR
    spec = grain.poseidon_spec(fr, 3)
    rng = random.Random(0xE17)
    pre = values or [rng.randrange(fr.modulus) for _ in range(2)]
    digest = grain.poseidon_hash(spec, pre)
    com = CC.R1CS(fr, mode=mode)
    known = mode == "prove"
    p_vars = [com.secret_witness(pre[i] if known else None) for i in range(2)]
    d = com.public_input(digest if known else None)
    com.assert_eq(CC.poseidon_hash(com, spec, p_vars), d)
    matrices, assignment = com.finalize()
    return matrices, assignment, digest, pre


@functools.lru_cache(maxsize=None)
def _setup():
    from manta_tpu_torch.models import groth16 as G
    from manta_tpu_torch.models import pairing as PR

    matrices, _, _, _ = _poseidon_preimage_circuit("setup")
    pk, vk = G.setup(PR.BN254_PAIRING, matrices, seed=3)
    return matrices, pk, vk


def small_prover(device="cuda"):
    """The Poseidon-preimage prover: (DeviceProver, matrices, vk)."""
    from manta_tpu_torch.models.groth16_device import DeviceProver

    matrices, pk, vk = _setup()
    prover = DeviceProver(pk, matrices, backend=BACKEND, window_bits=WINDOW_BITS,
                          column_steps=COLUMN_STEPS, device=device)
    return prover, matrices, vk


def entry(device="cuda"):
    """(fn, args): the device-prover core step and its witness arguments."""
    prover, _, _ = small_prover(device)
    _, assignment, _, _ = _poseidon_preimage_circuit("prove")
    z_mont, z_canon = prover._encode_witness(assignment)
    return prover._prove_core, (z_mont, z_canon)


def dryrun(device="cuda", r_rand: int = 7, s_rand: int = 9):
    """Prove the Poseidon preimage once and verify it; returns the proof."""
    from manta_tpu_torch.models import groth16 as G

    prover, _, vk = small_prover(device)
    _, assignment, digest, _ = _poseidon_preimage_circuit("prove")
    proof = prover.prove(assignment, r_rand, s_rand)
    if not G.verify(vk, proof, [digest]):
        raise AssertionError("the dry-run proof does not verify")
    return proof


def main() -> int:
    ap = argparse.ArgumentParser(description="prove and verify the Poseidon-preimage circuit")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args()
    dryrun(args.device)
    print(f"dry run on {args.device}: {BACKEND} proof verified")
    return 0


if __name__ == "__main__":
    sys.exit(main())
