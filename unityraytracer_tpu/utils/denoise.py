"""Edge-preserving denoising for progressive path-traced frames.

The reference ships no denoiser (its only convergence tool is the running
mean, AdditionShader.shader:40); a standalone production renderer needs one
for interactive preview. This is the a-trous wavelet filter of Dammertz et
al. 2010 ("Edge-Avoiding A-Trous Wavelet Transform for Fast Global
Illumination Filtering"), gather-free:

* Each iteration is a 5x5 B3-spline cross-bilateral pass with the kernel
  DILATED by 2^i — implemented as 25 shifted adds (jnp.roll) rather than a
  gather, so XLA fuses it into dense elementwise code.
* The range (edge-stopping) weight uses per-pixel color distance against a
  sigma that the caller scales, optionally multiplied by albedo/normal
  guide terms from the first-hit G-buffer (render.render_aovs) — the
  noise-free guides keep texture and silhouette edges when the color sigma
  is opened wide on 1-sample accumulations.

Pure function over (H, W, 3) arrays — jit-friendly, works on any backend.
"""

from __future__ import annotations

import jax.numpy as jnp

# B3 spline taps (outer product gives the 5x5 kernel).
_TAPS = (1.0 / 16.0, 4.0 / 16.0, 6.0 / 16.0, 4.0 / 16.0, 1.0 / 16.0)


def atrous_denoise(img, iterations: int = 3, sigma_color: float = 0.1,
                   albedo=None, normal=None, sigma_albedo: float = 0.15,
                   sigma_normal: float = 0.3):
    """Edge-avoiding a-trous filter, optionally G-buffer guided.

    Args:
      img: (H, W, 3) linear radiance.
      iterations: wavelet levels (dilation 1, 2, 4, ...). 3 suits preview;
        5 for very noisy 1-sample frames.
      sigma_color: range sigma in linear radiance units — smaller preserves
        more edges.
      albedo/normal: optional (H, W, 3) first-hit guide buffers
        (render.render_aovs). They are noise-free, so their edge-stopping
        terms keep texture and silhouette detail even when sigma_color is
        opened wide on very noisy accumulations (Dammertz et al. 2010 §4.1
        guide weights). Guides are NOT filtered across iterations.
      sigma_albedo/sigma_normal: range sigmas for the guide terms.
    Returns:
      (H, W, 3) filtered image.
    """
    img = jnp.asarray(img, jnp.float32)
    H, W = img.shape[0], img.shape[1]

    def inv2s2(s):
        return 1.0 / jnp.maximum(2.0 * s * s, 1e-12)

    inv_c = inv2s2(sigma_color)
    guides = []
    if albedo is not None:
        guides.append((jnp.asarray(albedo, jnp.float32),
                       inv2s2(sigma_albedo)))
    if normal is not None:
        guides.append((jnp.asarray(normal, jnp.float32),
                       inv2s2(sigma_normal)))
    out = img
    for level in range(iterations):
        step = 1 << level
        # Edge-clamped shifts via one pad + 25 static slices (all fusable).
        p = 2 * step
        padded = jnp.pad(out, ((p, p), (p, p), (0, 0)), mode="edge")
        gpad = [(jnp.pad(g, ((p, p), (p, p), (0, 0)), mode="edge"), inv_g)
                for g, inv_g in guides]
        acc = jnp.zeros_like(out)
        wsum = jnp.zeros((H, W, 1), jnp.float32)
        for dy in range(-2, 3):
            for dx in range(-2, 3):
                w_k = _TAPS[dy + 2] * _TAPS[dx + 2]
                y0 = p + dy * step
                x0 = p + dx * step
                shifted = padded[y0:y0 + H, x0:x0 + W, :]
                d2 = jnp.sum((shifted - out) ** 2, axis=-1, keepdims=True)
                logw = -d2 * inv_c
                for (gp, inv_g), (g, _) in zip(gpad, guides):
                    gs = gp[y0:y0 + H, x0:x0 + W, :]
                    gd2 = jnp.sum((gs - g) ** 2, axis=-1, keepdims=True)
                    logw = logw - gd2 * inv_g
                w = w_k * jnp.exp(logw)
                acc = acc + shifted * w
                wsum = wsum + w
        out = acc / jnp.maximum(wsum, 1e-12)
    return out
