# Copied from dav1d_mirror_tpu/ops/itx_1d.py.
"""AV1 inverse 1D transforms, vectorized and backend-agnostic.

Every function maps a list of n input vectors (NumPy or jax.numpy int32
arrays, or Python ints — anything supporting +, -, *, >> and .clip) to a list
of output vectors, applying the AV1 spec's integer butterfly networks with
bit-exact rounding.  The same code therefore serves as

* the NumPy reference interpreter (tested against the reference decoder's C
  kernels via the oracle shim), and
* the traced JAX/Pallas device implementation (vectors = batched lanes).

Semantics follow the AV1 specification, cross-checked against dav1d
``src/itx_1d.c`` (behavioral reference only — this is an independent
vectorized formulation; dav1d's ``(c-4096)``+add-back overflow idiom is
algebraically simplified to the plain spec constants, which is bit-identical
for spec-compliant input magnitudes).

DCT transforms of size N in "half-input" (tx64) mode take N/2 input vectors
and produce N outputs: AV1's 64-point transforms only consume the 32
low-frequency coefficients.
"""
from __future__ import annotations


def _clip(v, mn, mx):
    return v.clip(mn, mx) if hasattr(v, "clip") else max(mn, min(mx, v))


def _m(a, ca, b, cb, shift):
    """(a*ca + b*cb + (1 << (shift-1))) >> shift"""
    return (a * ca + b * cb + (1 << (shift - 1))) >> shift


def _m1(a, ca, shift):
    return (a * ca + (1 << (shift - 1))) >> shift


def idct4(i, mn, mx, half=False):
    if half:
        in0, in1 = i
        t0 = t1 = _m1(in0, 181, 8)
        t2 = _m1(in1, 1567, 12)
        t3 = _m1(in1, 3784, 12)
    else:
        in0, in1, in2, in3 = i
        t0 = _m1(in0 + in2, 181, 8)
        t1 = _m1(in0 - in2, 181, 8)
        t2 = _m(in1, 1567, in3, -3784, 12)
        t3 = _m(in1, 3784, in3, 1567, 12)
    c = lambda v: _clip(v, mn, mx)
    return [c(t0 + t3), c(t1 + t2), c(t1 - t2), c(t0 - t3)]


def idct8(i, mn, mx, half=False):
    e = idct4(i[::2], mn, mx, half)
    if half:
        in1, in3 = i[1::2]
        t4a = _m1(in1, 799, 12)
        t5a = _m1(in3, -2276, 12)
        t6a = _m1(in3, 3406, 12)
        t7a = _m1(in1, 4017, 12)
    else:
        in1, in3, in5, in7 = i[1::2]
        t4a = _m(in1, 799, in7, -4017, 12)
        t5a = _m(in5, 1703, in3, -1138, 11)
        t6a = _m(in5, 1138, in3, 1703, 11)
        t7a = _m(in1, 4017, in7, 799, 12)
    c = lambda v: _clip(v, mn, mx)
    t4 = c(t4a + t5a)
    t5a = c(t4a - t5a)
    t7 = c(t7a + t6a)
    t6a = c(t7a - t6a)
    t5 = _m1(t6a - t5a, 181, 8)
    t6 = _m1(t6a + t5a, 181, 8)
    return ([c(e[0] + t7), c(e[1] + t6), c(e[2] + t5), c(e[3] + t4),
             c(e[3] - t4), c(e[2] - t5), c(e[1] - t6), c(e[0] - t7)])


def idct16(i, mn, mx, half=False):
    e = idct8(i[::2], mn, mx, half)
    if half:
        in1, in3, in5, in7 = i[1::2]
        t8a = _m1(in1, 401, 12)
        t9a = _m1(in7, -2598, 12)
        t10a = _m1(in5, 1931, 12)
        t11a = _m1(in3, -1189, 12)
        t12a = _m1(in3, 3920, 12)
        t13a = _m1(in5, 3612, 12)
        t14a = _m1(in7, 3166, 12)
        t15a = _m1(in1, 4076, 12)
    else:
        in1, in3, in5, in7, in9, in11, in13, in15 = i[1::2]
        t8a = _m(in1, 401, in15, -4076, 12)
        t9a = _m(in9, 1583, in7, -1299, 11)
        t10a = _m(in5, 1931, in11, -3612, 12)
        t11a = _m(in13, 3920, in3, -1189, 12)
        t12a = _m(in13, 1189, in3, 3920, 12)
        t13a = _m(in5, 3612, in11, 1931, 12)
        t14a = _m(in9, 1299, in7, 1583, 11)
        t15a = _m(in1, 4076, in15, 401, 12)
    c = lambda v: _clip(v, mn, mx)

    t8 = c(t8a + t9a)
    t9 = c(t8a - t9a)
    t10 = c(t11a - t10a)
    t11 = c(t11a + t10a)
    t12 = c(t12a + t13a)
    t13 = c(t12a - t13a)
    t14 = c(t15a - t14a)
    t15 = c(t15a + t14a)

    t9a = _m(t14, 1567, t9, -3784, 12)
    t14a = _m(t14, 3784, t9, 1567, 12)
    t10a = _m(t13, -3784, t10, -1567, 12)
    t13a = _m(t13, 1567, t10, -3784, 12)

    t8a = c(t8 + t11)
    t9 = c(t9a + t10a)
    t10 = c(t9a - t10a)
    t11a = c(t8 - t11)
    t12a = c(t15 - t12)
    t13 = c(t14a - t13a)
    t14 = c(t14a + t13a)
    t15a = c(t15 + t12)

    t10a = _m1(t13 - t10, 181, 8)
    t13a = _m1(t13 + t10, 181, 8)
    t11 = _m1(t12a - t11a, 181, 8)
    t12 = _m1(t12a + t11a, 181, 8)

    odd = [t15a, t14, t13a, t12, t11, t10a, t9, t8a]
    return ([c(e[k] + odd[k]) for k in range(8)] +
            [c(e[7 - k] - odd[7 - k]) for k in range(8)])


def idct32(i, mn, mx, half=False):
    e = idct16(i[::2], mn, mx, half)
    if half:
        in1, in3, in5, in7, in9, in11, in13, in15 = i[1::2]
        t16a = _m1(in1, 201, 12)
        t17a = _m1(in15, -2751, 12)
        t18a = _m1(in9, 1751, 12)
        t19a = _m1(in7, -1380, 12)
        t20a = _m1(in5, 995, 12)
        t21a = _m1(in11, -2106, 12)
        t22a = _m1(in13, 2440, 12)
        t23a = _m1(in3, -601, 12)
        t24a = _m1(in3, 4052, 12)
        t25a = _m1(in13, 3290, 12)
        t26a = _m1(in11, 3513, 12)
        t27a = _m1(in5, 3973, 12)
        t28a = _m1(in7, 3857, 12)
        t29a = _m1(in9, 3703, 12)
        t30a = _m1(in15, 3035, 12)
        t31a = _m1(in1, 4091, 12)
    else:
        (in1, in3, in5, in7, in9, in11, in13, in15,
         in17, in19, in21, in23, in25, in27, in29, in31) = i[1::2]
        t16a = _m(in1, 201, in31, -4091, 12)
        t17a = _m(in17, 3035, in15, -2751, 12)
        t18a = _m(in9, 1751, in23, -3703, 12)
        t19a = _m(in25, 3857, in7, -1380, 12)
        t20a = _m(in5, 995, in27, -3973, 12)
        t21a = _m(in21, 3513, in11, -2106, 12)
        t22a = _m(in13, 1220, in19, -1645, 11)
        t23a = _m(in29, 4052, in3, -601, 12)
        t24a = _m(in29, 601, in3, 4052, 12)
        t25a = _m(in13, 1645, in19, 1220, 11)
        t26a = _m(in21, 2106, in11, 3513, 12)
        t27a = _m(in5, 3973, in27, 995, 12)
        t28a = _m(in25, 1380, in7, 3857, 12)
        t29a = _m(in9, 3703, in23, 1751, 12)
        t30a = _m(in17, 2751, in15, 3035, 12)
        t31a = _m(in1, 4091, in31, 201, 12)
    c = lambda v: _clip(v, mn, mx)

    t16 = c(t16a + t17a)
    t17 = c(t16a - t17a)
    t18 = c(t19a - t18a)
    t19 = c(t19a + t18a)
    t20 = c(t20a + t21a)
    t21 = c(t20a - t21a)
    t22 = c(t23a - t22a)
    t23 = c(t23a + t22a)
    t24 = c(t24a + t25a)
    t25 = c(t24a - t25a)
    t26 = c(t27a - t26a)
    t27 = c(t27a + t26a)
    t28 = c(t28a + t29a)
    t29 = c(t28a - t29a)
    t30 = c(t31a - t30a)
    t31 = c(t31a + t30a)

    t17a = _m(t30, 799, t17, -4017, 12)
    t30a = _m(t30, 4017, t17, 799, 12)
    t18a = _m(t29, -4017, t18, -799, 12)
    t29a = _m(t29, 799, t18, -4017, 12)
    t21a = _m(t26, 1703, t21, -1138, 11)
    t26a = _m(t26, 1138, t21, 1703, 11)
    t22a = _m(t25, -1138, t22, -1703, 11)
    t25a = _m(t25, 1703, t22, -1138, 11)

    t16a = c(t16 + t19)
    t17_ = c(t17a + t18a)
    t18 = c(t17a - t18a)
    t19a = c(t16 - t19)
    t20a = c(t23 - t20)
    t21 = c(t22a - t21a)
    t22 = c(t22a + t21a)
    t23a = c(t23 + t20)
    t24a = c(t24 + t27)
    t25_ = c(t25a + t26a)
    t26 = c(t25a - t26a)
    t27a = c(t24 - t27)
    t28a = c(t31 - t28)
    t29_ = c(t30a - t29a)
    t30 = c(t30a + t29a)
    t31a = c(t31 + t28)
    t17, t25, t29 = t17_, t25_, t29_

    t18a = _m(t29, 1567, t18, -3784, 12)
    t29a = _m(t29, 3784, t18, 1567, 12)
    t19_ = _m(t28a, 1567, t19a, -3784, 12)
    t28 = _m(t28a, 3784, t19a, 1567, 12)
    t20 = _m(t27a, -3784, t20a, -1567, 12)
    t27 = _m(t27a, 1567, t20a, -3784, 12)
    t21a = _m(t26, -3784, t21, -1567, 12)
    t26a = _m(t26, 1567, t21, -3784, 12)
    t19 = t19_

    t16 = c(t16a + t23a)
    t17a = c(t17 + t22)
    t18 = c(t18a + t21a)
    t19a = c(t19 + t20)
    t20a = c(t19 - t20)
    t21 = c(t18a - t21a)
    t22a = c(t17 - t22)
    t23 = c(t16a - t23a)
    t24 = c(t31a - t24a)
    t25a = c(t30 - t25)
    t26 = c(t29a - t26a)
    t27a = c(t28 - t27)
    t28a = c(t28 + t27)
    t29 = c(t29a + t26a)
    t30a = c(t30 + t25)
    t31 = c(t31a + t24a)

    t20 = _m1(t27a - t20a, 181, 8)
    t27 = _m1(t27a + t20a, 181, 8)
    t21a = _m1(t26 - t21, 181, 8)
    t26a = _m1(t26 + t21, 181, 8)
    t22 = _m1(t25a - t22a, 181, 8)
    t25 = _m1(t25a + t22a, 181, 8)
    t23a = _m1(t24 - t23, 181, 8)
    t24a = _m1(t24 + t23, 181, 8)

    odd = [t31, t30a, t29, t28a, t27, t26a, t25, t24a,
           t23a, t22, t21a, t20, t19a, t18, t17a, t16]
    return ([c(e[k] + odd[k]) for k in range(16)] +
            [c(e[15 - k] - odd[15 - k]) for k in range(16)])


def idct64(i, mn, mx):
    # The 64-point DCT consumes exactly 32 low-frequency inputs.
    assert len(i) == 32
    e = idct32(i[::2], mn, mx, half=True)
    (in1, in3, in5, in7, in9, in11, in13, in15,
     in17, in19, in21, in23, in25, in27, in29, in31) = i[1::2]
    c = lambda v: _clip(v, mn, mx)

    t32a = _m1(in1, 101, 12)
    t33a = _m1(in31, -2824, 12)
    t34a = _m1(in17, 1660, 12)
    t35a = _m1(in15, -1474, 12)
    t36a = _m1(in9, 897, 12)
    t37a = _m1(in23, -2191, 12)
    t38a = _m1(in25, 2359, 12)
    t39a = _m1(in7, -700, 12)
    t40a = _m1(in5, 501, 12)
    t41a = _m1(in27, -2520, 12)
    t42a = _m1(in21, 2019, 12)
    t43a = _m1(in11, -1092, 12)
    t44a = _m1(in13, 1285, 12)
    t45a = _m1(in19, -1842, 12)
    t46a = _m1(in29, 2675, 12)
    t47a = _m1(in3, -301, 12)
    t48a = _m1(in3, 4085, 12)
    t49a = _m1(in29, 3102, 12)
    t50a = _m1(in19, 3659, 12)
    t51a = _m1(in13, 3889, 12)
    t52a = _m1(in11, 3948, 12)
    t53a = _m1(in21, 3564, 12)
    t54a = _m1(in27, 3229, 12)
    t55a = _m1(in5, 4065, 12)
    t56a = _m1(in7, 4036, 12)
    t57a = _m1(in25, 3349, 12)
    t58a = _m1(in23, 3461, 12)
    t59a = _m1(in9, 3996, 12)
    t60a = _m1(in15, 3822, 12)
    t61a = _m1(in17, 3745, 12)
    t62a = _m1(in31, 2967, 12)
    t63a = _m1(in1, 4095, 12)

    t32 = c(t32a + t33a)
    t33 = c(t32a - t33a)
    t34 = c(t35a - t34a)
    t35 = c(t35a + t34a)
    t36 = c(t36a + t37a)
    t37 = c(t36a - t37a)
    t38 = c(t39a - t38a)
    t39 = c(t39a + t38a)
    t40 = c(t40a + t41a)
    t41 = c(t40a - t41a)
    t42 = c(t43a - t42a)
    t43 = c(t43a + t42a)
    t44 = c(t44a + t45a)
    t45 = c(t44a - t45a)
    t46 = c(t47a - t46a)
    t47 = c(t47a + t46a)
    t48 = c(t48a + t49a)
    t49 = c(t48a - t49a)
    t50 = c(t51a - t50a)
    t51 = c(t51a + t50a)
    t52 = c(t52a + t53a)
    t53 = c(t52a - t53a)
    t54 = c(t55a - t54a)
    t55 = c(t55a + t54a)
    t56 = c(t56a + t57a)
    t57 = c(t56a - t57a)
    t58 = c(t59a - t58a)
    t59 = c(t59a + t58a)
    t60 = c(t60a + t61a)
    t61 = c(t60a - t61a)
    t62 = c(t63a - t62a)
    t63 = c(t63a + t62a)

    t33a = _m(t33, -4076, t62, 401, 12)
    t34a = _m(t34, -401, t61, -4076, 12)
    t37a = _m(t37, -1299, t58, 1583, 11)
    t38a = _m(t38, -1583, t57, -1299, 11)
    t41a = _m(t41, -3612, t54, 1931, 12)
    t42a = _m(t42, -1931, t53, -3612, 12)
    t45a = _m(t45, -1189, t50, 3920, 12)
    t46a = _m(t46, -3920, t49, -1189, 12)
    t49a = _m(t46, -1189, t49, 3920, 12)
    t50a = _m(t45, 3920, t50, 1189, 12)
    t53a = _m(t42, -3612, t53, 1931, 12)
    t54a = _m(t41, 1931, t54, 3612, 12)
    t57a = _m(t38, -1299, t57, 1583, 11)
    t58a = _m(t37, 1583, t58, 1299, 11)
    t61a = _m(t34, -4076, t61, 401, 12)
    t62a = _m(t33, 401, t62, 4076, 12)

    t32a = c(t32 + t35)
    t33 = c(t33a + t34a)
    t34 = c(t33a - t34a)
    t35a = c(t32 - t35)
    t36a = c(t39 - t36)
    t37 = c(t38a - t37a)
    t38 = c(t38a + t37a)
    t39a = c(t39 + t36)
    t40a = c(t40 + t43)
    t41 = c(t41a + t42a)
    t42 = c(t41a - t42a)
    t43a = c(t40 - t43)
    t44a = c(t47 - t44)
    t45 = c(t46a - t45a)
    t46 = c(t46a + t45a)
    t47a = c(t47 + t44)
    t48a = c(t48 + t51)
    t49 = c(t49a + t50a)
    t50 = c(t49a - t50a)
    t51a = c(t48 - t51)
    t52a = c(t55 - t52)
    t53 = c(t54a - t53a)
    t54 = c(t54a + t53a)
    t55a = c(t55 + t52)
    t56a = c(t56 + t59)
    t57 = c(t57a + t58a)
    t58 = c(t57a - t58a)
    t59a = c(t56 - t59)
    t60a = c(t63 - t60)
    t61 = c(t62a - t61a)
    t62 = c(t62a + t61a)
    t63a = c(t63 + t60)

    t34a = _m(t34, -4017, t61, 799, 12)
    t35_ = _m(t35a, -4017, t60a, 799, 12)
    t36_ = _m(t36a, -799, t59a, -4017, 12)
    t37a = _m(t37, -799, t58, -4017, 12)
    t42a = _m(t42, -1138, t53, 1703, 11)
    t43_ = _m(t43a, -1138, t52a, 1703, 11)
    t44_ = _m(t44a, -1703, t51a, -1138, 11)
    t45a = _m(t45, -1703, t50, -1138, 11)
    t50a = _m(t45, -1138, t50, 1703, 11)
    t51_ = _m(t44a, -1138, t51a, 1703, 11)
    t52_ = _m(t43a, 1703, t52a, 1138, 11)
    t53a = _m(t42, 1703, t53, 1138, 11)
    t58a = _m(t37, -4017, t58, 799, 12)
    t59_ = _m(t36a, -4017, t59a, 799, 12)
    t60_ = _m(t35a, 799, t60a, 4017, 12)
    t61a = _m(t34, 799, t61, 4017, 12)
    t35, t36, t43, t44 = t35_, t36_, t43_, t44_
    t51, t52, t59, t60 = t51_, t52_, t59_, t60_

    t32 = c(t32a + t39a)
    t33a = c(t33 + t38)
    t34_ = c(t34a + t37a)
    t35a = c(t35 + t36)
    t36a = c(t35 - t36)
    t37_ = c(t34a - t37a)
    t38a = c(t33 - t38)
    t39 = c(t32a - t39a)
    t40 = c(t47a - t40a)
    t41a = c(t46 - t41)
    t42_ = c(t45a - t42a)
    t43a = c(t44 - t43)
    t44a = c(t44 + t43)
    t45_ = c(t45a + t42a)
    t46a = c(t46 + t41)
    t47 = c(t47a + t40a)
    t48_ = c(t48a + t55a)
    t49a = c(t49 + t54)
    t50_ = c(t50a + t53a)
    t51a = c(t51 + t52)
    t52a = c(t51 - t52)
    t53_ = c(t50a - t53a)
    t54a = c(t49 - t54)
    t55_ = c(t48a - t55a)
    t56_ = c(t63a - t56a)
    t57a = c(t62 - t57)
    t58_ = c(t61a - t58a)
    t59a = c(t60 - t59)
    t60a = c(t60 + t59)
    t61_ = c(t61a + t58a)
    t62a = c(t62 + t57)
    t63 = c(t63a + t56a)
    t34, t37, t42, t45 = t34_, t37_, t42_, t45_
    t48, t50, t53, t55 = t48_, t50_, t53_, t55_
    t56, t58, t61 = t56_, t58_, t61_

    t36 = _m(t36a, -3784, t59a, 1567, 12)
    t37a = _m(t37, -3784, t58, 1567, 12)
    t38_ = _m(t38a, -3784, t57a, 1567, 12)
    t39a = _m(t39, -3784, t56, 1567, 12)
    t40a = _m(t40, -1567, t55, -3784, 12)
    t41_ = _m(t41a, -1567, t54a, -3784, 12)
    t42a = _m(t42, -1567, t53, -3784, 12)
    t43_ = _m(t43a, -1567, t52a, -3784, 12)
    t52_ = _m(t43a, -3784, t52a, 1567, 12)
    t53a = _m(t42, -3784, t53, 1567, 12)
    t54_ = _m(t41a, -3784, t54a, 1567, 12)
    t55a = _m(t40, -3784, t55, 1567, 12)
    t56a = _m(t39, 1567, t56, 3784, 12)
    t57_ = _m(t38a, 1567, t57a, 3784, 12)
    t58a = _m(t37, 1567, t58, 3784, 12)
    t59_ = _m(t36a, 1567, t59a, 3784, 12)
    t38, t41, t43 = t38_, t41_, t43_
    t52, t54, t57, t59 = t52_, t54_, t57_, t59_

    t32a = c(t32 + t47)
    t33_ = c(t33a + t46a)
    t34a = c(t34 + t45)
    t35_ = c(t35a + t44a)
    t36a = c(t36 + t43)
    t37_ = c(t37a + t42a)
    t38a = c(t38 + t41)
    t39_ = c(t39a + t40a)
    t40_ = c(t39a - t40a)
    t41a = c(t38 - t41)
    t42_ = c(t37a - t42a)
    t43a = c(t36 - t43)
    t44_ = c(t35a - t44a)
    t45a = c(t34 - t45)
    t46_ = c(t33a - t46a)
    t47a = c(t32 - t47)
    t48a = c(t63 - t48)
    t49_ = c(t62a - t49a)
    t50a = c(t61 - t50)
    t51_ = c(t60a - t51a)
    t52a = c(t59 - t52)
    t53_ = c(t58a - t53a)
    t54a = c(t57 - t54)
    t55_ = c(t56a - t55a)
    t56_ = c(t56a + t55a)
    t57a = c(t57 + t54)
    t58_ = c(t58a + t53a)
    t59a = c(t59 + t52)
    t60_ = c(t60a + t51a)
    t61a = c(t61 + t50)
    t62_ = c(t62a + t49a)
    t63a = c(t63 + t48)
    t33, t35, t37, t39 = t33_, t35_, t37_, t39_
    t40, t42, t44, t46 = t40_, t42_, t44_, t46_
    t49, t51, t53, t55 = t49_, t51_, t53_, t55_
    t56, t58, t60, t62 = t56_, t58_, t60_, t62_

    t40a = _m1(t55 - t40, 181, 8)
    t41_ = _m1(t54a - t41a, 181, 8)
    t42a = _m1(t53 - t42, 181, 8)
    t43_ = _m1(t52a - t43a, 181, 8)
    t44a = _m1(t51 - t44, 181, 8)
    t45_ = _m1(t50a - t45a, 181, 8)
    t46a = _m1(t49 - t46, 181, 8)
    t47_ = _m1(t48a - t47a, 181, 8)
    t48_ = _m1(t47a + t48a, 181, 8)
    t49a = _m1(t46 + t49, 181, 8)
    t50_ = _m1(t45a + t50a, 181, 8)
    t51a = _m1(t44 + t51, 181, 8)
    t52_ = _m1(t43a + t52a, 181, 8)
    t53a = _m1(t42 + t53, 181, 8)
    t54_ = _m1(t41a + t54a, 181, 8)
    t55a = _m1(t40 + t55, 181, 8)
    t41, t43, t45, t47 = t41_, t43_, t45_, t47_
    t48, t50, t52, t54 = t48_, t50_, t52_, t54_

    odd = [t63a, t62, t61a, t60, t59a, t58, t57a, t56,
           t55a, t54, t53a, t52, t51a, t50, t49a, t48,
           t47, t46a, t45, t44a, t43, t42a, t41, t40a,
           t39, t38a, t37, t36a, t35, t34a, t33, t32a]
    return ([c(e[k] + odd[k]) for k in range(32)] +
            [c(e[31 - k] - odd[31 - k]) for k in range(32)])


def iadst4(i, mn, mx):
    in0, in1, in2, in3 = i
    o0 = (1321 * in0 + 3803 * in2 + 2482 * in3 + 3344 * in1 + 2048) >> 12
    o1 = (2482 * in0 - 1321 * in2 - 3803 * in3 + 3344 * in1 + 2048) >> 12
    o2 = (209 * (in0 - in2 + in3) + 128) >> 8
    o3 = (3803 * in0 + 2482 * in2 - 1321 * in3 - 3344 * in1 + 2048) >> 12
    return [o0, o1, o2, o3]


def iadst8(i, mn, mx):
    in0, in1, in2, in3, in4, in5, in6, in7 = i
    c = lambda v: _clip(v, mn, mx)

    t0a = _m(in7, 4076, in0, 401, 12)
    t1a = _m(in7, 401, in0, -4076, 12)
    t2a = _m(in5, 3612, in2, 1931, 12)
    t3a = _m(in5, 1931, in2, -3612, 12)
    t4a = _m(in3, 1299, in4, 1583, 11)
    t5a = _m(in3, 1583, in4, -1299, 11)
    t6a = _m(in1, 1189, in6, 3920, 12)
    t7a = _m(in1, 3920, in6, -1189, 12)

    t0 = c(t0a + t4a)
    t1 = c(t1a + t5a)
    t2 = c(t2a + t6a)
    t3 = c(t3a + t7a)
    t4 = c(t0a - t4a)
    t5 = c(t1a - t5a)
    t6 = c(t2a - t6a)
    t7 = c(t3a - t7a)

    t4a = _m(t4, 3784, t5, 1567, 12)
    t5a = _m(t4, 1567, t5, -3784, 12)
    t6a = _m(t7, 3784, t6, -1567, 12)
    t7a = _m(t7, 1567, t6, 3784, 12)

    o0 = c(t0 + t2)
    o7 = -c(t1 + t3)
    t2 = c(t0 - t2)
    t3 = c(t1 - t3)
    o1 = -c(t4a + t6a)
    o6 = c(t5a + t7a)
    t6 = c(t4a - t6a)
    t7 = c(t5a - t7a)

    o3 = -(_m1(t2 + t3, 181, 8))
    o4 = _m1(t2 - t3, 181, 8)
    o2 = _m1(t6 + t7, 181, 8)
    o5 = -(_m1(t6 - t7, 181, 8))
    return [o0, o1, o2, o3, o4, o5, o6, o7]


def iadst16(i, mn, mx):
    (in0, in1, in2, in3, in4, in5, in6, in7,
     in8, in9, in10, in11, in12, in13, in14, in15) = i
    c = lambda v: _clip(v, mn, mx)

    t0 = _m(in15, 4091, in0, 201, 12)
    t1 = _m(in15, 201, in0, -4091, 12)
    t2 = _m(in13, 3973, in2, 995, 12)
    t3 = _m(in13, 995, in2, -3973, 12)
    t4 = _m(in11, 3703, in4, 1751, 12)
    t5 = _m(in11, 1751, in4, -3703, 12)
    t6 = _m(in9, 1645, in6, 1220, 11)
    t7 = _m(in9, 1220, in6, -1645, 11)
    t8 = _m(in7, 2751, in8, 3035, 12)
    t9 = _m(in7, 3035, in8, -2751, 12)
    t10 = _m(in5, 2106, in10, 3513, 12)
    t11 = _m(in5, 3513, in10, -2106, 12)
    t12 = _m(in3, 1380, in12, 3857, 12)
    t13 = _m(in3, 3857, in12, -1380, 12)
    t14 = _m(in1, 601, in14, 4052, 12)
    t15 = _m(in1, 4052, in14, -601, 12)

    t0a = c(t0 + t8)
    t1a = c(t1 + t9)
    t2a = c(t2 + t10)
    t3a = c(t3 + t11)
    t4a = c(t4 + t12)
    t5a = c(t5 + t13)
    t6a = c(t6 + t14)
    t7a = c(t7 + t15)
    t8a = c(t0 - t8)
    t9a = c(t1 - t9)
    t10a = c(t2 - t10)
    t11a = c(t3 - t11)
    t12a = c(t4 - t12)
    t13a = c(t5 - t13)
    t14a = c(t6 - t14)
    t15a = c(t7 - t15)

    t8 = _m(t8a, 4017, t9a, 799, 12)
    t9 = _m(t8a, 799, t9a, -4017, 12)
    t10 = _m(t10a, 2276, t11a, 3406, 12)
    t11 = _m(t10a, 3406, t11a, -2276, 12)
    t12 = _m(t13a, 4017, t12a, -799, 12)
    t13 = _m(t13a, 799, t12a, 4017, 12)
    t14 = _m(t15a, 2276, t14a, -3406, 12)
    t15 = _m(t15a, 3406, t14a, 2276, 12)

    t0 = c(t0a + t4a)
    t1 = c(t1a + t5a)
    t2 = c(t2a + t6a)
    t3 = c(t3a + t7a)
    t4 = c(t0a - t4a)
    t5 = c(t1a - t5a)
    t6 = c(t2a - t6a)
    t7 = c(t3a - t7a)
    t8a = c(t8 + t12)
    t9a = c(t9 + t13)
    t10a = c(t10 + t14)
    t11a = c(t11 + t15)
    t12a = c(t8 - t12)
    t13a = c(t9 - t13)
    t14a = c(t10 - t14)
    t15a = c(t11 - t15)

    t4a = _m(t4, 3784, t5, 1567, 12)
    t5a = _m(t4, 1567, t5, -3784, 12)
    t6a = _m(t7, 3784, t6, -1567, 12)
    t7a = _m(t7, 1567, t6, 3784, 12)
    t12 = _m(t12a, 3784, t13a, 1567, 12)
    t13 = _m(t12a, 1567, t13a, -3784, 12)
    t14 = _m(t15a, 3784, t14a, -1567, 12)
    t15 = _m(t15a, 1567, t14a, 3784, 12)

    o0 = c(t0 + t2)
    o15 = -c(t1 + t3)
    t2a = c(t0 - t2)
    t3a = c(t1 - t3)
    o3 = -c(t4a + t6a)
    o12 = c(t5a + t7a)
    t6 = c(t4a - t6a)
    t7 = c(t5a - t7a)
    o1 = -c(t8a + t10a)
    o14 = c(t9a + t11a)
    t10 = c(t8a - t10a)
    t11 = c(t9a - t11a)
    o2 = c(t12 + t14)
    o13 = -c(t13 + t15)
    t14a = c(t12 - t14)
    t15a = c(t13 - t15)

    o7 = -(_m1(t2a + t3a, 181, 8))
    o8 = _m1(t2a - t3a, 181, 8)
    o4 = _m1(t6 + t7, 181, 8)
    o11 = -(_m1(t6 - t7, 181, 8))
    o6 = _m1(t10 + t11, 181, 8)
    o9 = -(_m1(t10 - t11, 181, 8))
    o5 = -(_m1(t14a + t15a, 181, 8))
    o10 = _m1(t14a - t15a, 181, 8)
    return [o0, o1, o2, o3, o4, o5, o6, o7,
            o8, o9, o10, o11, o12, o13, o14, o15]


def iflipadst4(i, mn, mx):
    return iadst4(i, mn, mx)[::-1]


def iflipadst8(i, mn, mx):
    return iadst8(i, mn, mx)[::-1]


def iflipadst16(i, mn, mx):
    return iadst16(i, mn, mx)[::-1]


def iidentity4(i, mn, mx):
    return [v + ((v * 1697 + 2048) >> 12) for v in i]


def iidentity8(i, mn, mx):
    return [v * 2 for v in i]


def iidentity16(i, mn, mx):
    return [2 * v + ((v * 1697 + 1024) >> 11) for v in i]


def iidentity32(i, mn, mx):
    return [v * 4 for v in i]


def iwht4(i):
    in0, in1, in2, in3 = i
    t0 = in0 + in1
    t2 = in2 - in3
    t4 = (t0 - t2) >> 1
    t3 = t4 - in3
    t1 = t4 - in1
    return [t0 - t3, t3, t1, t2 + t1]


# transform family name -> {n: fn}
DCT = {4: idct4, 8: idct8, 16: idct16, 32: idct32, 64: idct64}
ADST = {4: iadst4, 8: iadst8, 16: iadst16}
FLIPADST = {4: iflipadst4, 8: iflipadst8, 16: iflipadst16}
IDENTITY = {4: iidentity4, 8: iidentity8, 16: iidentity16, 32: iidentity32}


def get_1d_fn(family: str, n: int):
    """family in {'dct','adst','flipadst','identity'} -> callable(i, mn, mx)."""
    if family == "dct":
        fn = DCT[n]
        return fn
    if family == "adst":
        return ADST[n]
    if family == "flipadst":
        return FLIPADST[n]
    if family == "identity":
        return IDENTITY[n]
    raise ValueError(family)
