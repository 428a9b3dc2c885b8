"""Field, curve and protocol parameters of the port.

A copy of `plonk_tpu/utils/params.py`, so that the port imports nothing
of the JAX package: the dataclasses `FieldParams`, `CurveParams` and
`PlonkParams`, the toy "PLONK by hand" preset (`HF17`, `GF101`,
`TOY_CURVE`, `TOY_PLONK`), `BABYBEAR`, the scaled pairing curve
(`SCALED_FR`, `SCALED_FQ`, `SCALED_CURVE`, `scaled_plonk_params`), the
production scalar fields `BN254_FR` and `BLS12_381_FR`, and
`PRESET_FIELDS`. The values are the same; the tests hold the two modules
against each other.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class FieldParams:
    """A prime field F_p. `generator` generates the multiplicative group;
    `two_adicity` is v_2(p-1), bounding radix-2 NTT domain sizes."""
    p: int
    name: str
    generator: int
    two_adicity: int

    def root_of_unity(self, order: int) -> int:
        """A primitive `order`-th root of unity (order must divide p-1)."""
        if (self.p - 1) % order != 0:
            raise ValueError(f"no order-{order} root of unity in {self.name}")
        w = pow(self.generator, (self.p - 1) // order, self.p)
        return w


@dataclasses.dataclass(frozen=True)
class CurveParams:
    """Short Weierstrass curve y^2 = x^3 + b over F_p with an order-r G1
    subgroup, embedding degree k=2, and G2 on the quadratic twist by `d`
    (so GT = F_{p^2} = F_p[u]/(u^2 - d))."""
    base: FieldParams        # coordinates field (GF in the reference)
    scalar: FieldParams      # subgroup order field (HF in the reference)
    b: int                   # curve constant
    g1_gen: tuple            # (x, y)
    g2_gen: tuple            # (x, y) twist coordinates
    d: int                   # u^2 = d (non-residue); reference: -2 mod 101
    embedding_degree: int = 2

    @property
    def r(self) -> int:
        return self.scalar.p

    @property
    def final_exp(self) -> int:
        # (p^k - 1) / r; reference src/pairing.h:71-78
        return (self.base.p ** self.embedding_degree - 1) // self.r


@dataclasses.dataclass(frozen=True)
class PlonkParams:
    """Domain / coset configuration for the PLONK protocol instance.
    Reference: src/plonk.h:12-14."""
    curve: CurveParams
    omega: int   # generator of the evaluation domain H in the scalar field
    k1: int      # coset shift for right wires
    k2: int      # coset shift for output wires

    @property
    def field(self) -> FieldParams:
        return self.curve.scalar


# --- the toy "PLONK by hand" preset (bit-exact parity anchor) ---

# F17: scalar field. 3 is a primitive root mod 17; 17-1 = 16 = 2^4.
HF17 = FieldParams(p=17, name="F17", generator=3, two_adicity=4)
# F101: base field. 2 is a primitive root mod 101; 101-1 = 100 = 4*25.
GF101 = FieldParams(p=101, name="F101", generator=2, two_adicity=2)

TOY_CURVE = CurveParams(
    base=GF101,
    scalar=HF17,
    b=3,
    g1_gen=(1, 2),
    g2_gen=(36, 31),
    d=101 - 2,  # u^2 = -2 (src/gt.h:24)
)

TOY_PLONK = PlonkParams(curve=TOY_CURVE, omega=4, k1=2, k2=3)

# --- scaled NTT-friendly field presets ---

# BabyBear: p = 15 * 2^27 + 1. Two-adicity 27 supports radix-2 NTT domains up
# to 2^27 elements. 31 generates F_p^*.
BABYBEAR = FieldParams(p=15 * (1 << 27) + 1, name="BabyBear", generator=31,
                       two_adicity=27)

# --- the scaled pairing curve (full PLONK at 2^16+ gates) ---
#
# Same construction as the toy curve, scaled up (derived with sympy, see
# tools/params_search.py): r = 27*2^22 + 1 prime (NTT domains to 2^22),
# p = 18*r - 1 prime with p = 2 mod 3, so y^2 = x^3 + 3 over F_p is
# supersingular with exactly p + 1 = 18*r points and embedding degree 2
# (r | p + 1 | p^2 - 1). G1/G2 generators are cofactor-cleared base points;
# the twist uses the non-residue d = 3 (u^2 = 3).

SCALED_FR = FieldParams(p=27 * (1 << 22) + 1, name="Fr-scaled", generator=7,
                        two_adicity=22)
SCALED_FQ = FieldParams(p=2038431761, name="Fq-scaled", generator=3,
                        two_adicity=4)

SCALED_CURVE = CurveParams(
    base=SCALED_FQ,
    scalar=SCALED_FR,
    b=3,
    g1_gen=(632911376, 1963803140),
    g2_gen=(679336793, 1218545681),
    d=3,
)

def scaled_plonk_params(n: int) -> PlonkParams:
    """PlonkParams for a scaled circuit with domain size n (power of two).

    omega is the order-n root; k1 = 7 (a generator of F_r^*, so its order
    is not a power of two -> never in H) and k2 = 49 (order (r-1)/2, also
    divisible by 27 -> not in H, and k2/k1 = 7 not in H -> k2 not in k1*H).
    The same membership checks the reference does (src/plonk.h:74-99) run
    again at context construction."""
    return PlonkParams(curve=SCALED_CURVE,
                       omega=SCALED_FR.root_of_unity(n), k1=7, k2=49)

# --- production pairing-curve scalar fields (multi-limb, ops/bigfield.py) ---
#
# These are the 254/255-bit NTT-friendly fields real PLONK deployments use;
# generator/two-adicity values match the standard arkworks/gnark constants.

BN254_FR = FieldParams(
    p=21888242871839275222246405745257275088548364400416034343698204186575808495617,
    name="BN254-Fr", generator=5, two_adicity=28)

BLS12_381_FR = FieldParams(
    p=52435875175126190479447740508185965837690552500527637822603658699938581184513,
    name="BLS12-381-Fr", generator=7, two_adicity=32)

PRESET_FIELDS = {"F17": HF17, "F101": GF101, "BabyBear": BABYBEAR,
                 "Fr-scaled": SCALED_FR, "Fq-scaled": SCALED_FQ,
                 "BN254-Fr": BN254_FR, "BLS12-381-Fr": BLS12_381_FR}
