"""Reader for the canonical (non-pickle) verifying-key files.

Same layout as the JAX package's `utils/keyio.py` (all integers
little-endian):
  header:  magic "MTKS" | u32 version | u8 curve-id (0 = BN254)
  vk:      alpha_g1 | beta_g2 | gamma_g2 | delta_g2 | g1_list gamma_abc
with points stored uncompressed (x||y, ark-serialize 0.3 flags) and lists
prefixed by a u64 length. Only the verifying-key half is here; proving keys
reach the device prover through `DeviceProver.from_cache`.
"""

from __future__ import annotations

import struct

from manta_tpu_torch.models import groth16 as G
from manta_tpu_torch.models import pairing as PR
from manta_tpu_torch.utils import codec

MAGIC = b"MTKS"
VERSION = 1

_CURVES_REV = {0: "bn254", 1: "bls12_381"}
_CONFIGS = {"bn254": PR.BN254_PAIRING, "bls12_381": PR.BLS12_381_PAIRING}


class Reader:
    def __init__(self, cfg: PR.PairingConfig, data: bytes):
        self.cfg = cfg
        self.data = data
        self.pos = 0
        fq = codec.field_byte_size(cfg.g1.field)
        self._g1 = 2 * fq
        self._g2 = 4 * fq

    def take(self, n: int) -> bytes:
        out = self.data[self.pos : self.pos + n]
        if len(out) != n:
            raise ValueError("truncated key data")
        self.pos += n
        return out

    def u64(self) -> int:
        return struct.unpack("<Q", self.take(8))[0]

    def g1(self):
        return codec.deserialize_g1_uncompressed(self.take(self._g1), self.cfg.g1)

    def g2(self):
        return codec.deserialize_g2_uncompressed(self.take(self._g2), self.cfg.g2)

    def g1_list(self):
        return [self.g1() for _ in range(self.u64())]

    def at_end(self) -> bool:
        return self.pos == len(self.data)


def read_vk(r: Reader) -> G.VerifyingKey:
    return G.VerifyingKey(
        cfg=r.cfg,
        alpha_g1=r.g1(),
        beta_g2=r.g2(),
        gamma_g2=r.g2(),
        delta_g2=r.g2(),
        gamma_abc_g1=r.g1_list(),
    )


def _check_header(data: bytes) -> PR.PairingConfig:
    if data[:4] != MAGIC:
        raise ValueError("not a manta_tpu key file")
    version, curve_id = struct.unpack("<IB", data[4:9])
    if version != VERSION:
        raise ValueError(f"unsupported key-file version {version}")
    if curve_id not in _CURVES_REV:
        raise ValueError(f"unknown curve id {curve_id}")
    return _CONFIGS[_CURVES_REV[curve_id]]


def vk_from_bytes(data: bytes) -> G.VerifyingKey:
    cfg = _check_header(data)
    r = Reader(cfg, data[9:])
    vk = read_vk(r)
    if not r.at_end():
        raise ValueError("trailing bytes in vk file")
    return vk
