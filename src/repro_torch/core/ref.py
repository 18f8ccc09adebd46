"""Pure-numpy reference HDP sampler, the statistical oracle (counterpart
of ``repro/core/ref.py``).

Implements Algorithm 1/2 with no sparsity tricks, no alias tables, and no
vectorization: a direct transcription of the paper's full conditionals.
The tests hold the port's sampler to it in distribution. It runs on the
host only; every numpy call comes in the reference's order, so one seed
gives the reference's arrays.
"""

from __future__ import annotations

import numpy as np


class RefHDP:
    def __init__(self, docs, V, K=50, alpha=0.1, beta=0.01, gamma=1.0, seed=0,
                 use_ppu=True):
        self.docs = [np.asarray(d, dtype=np.int64) for d in docs]
        self.V, self.K = V, K
        self.alpha, self.beta, self.gamma = alpha, beta, gamma
        self.rng = np.random.default_rng(seed)
        self.use_ppu = use_ppu
        self.z = [np.zeros(len(d), dtype=np.int64) for d in self.docs]
        self.n = np.zeros((K, V), dtype=np.int64)
        for d, zd in zip(self.docs, self.z):
            np.add.at(self.n, (zd, d), 1)
        self.psi = self._gem_prior()
        self.phi = self._phi_step()

    def _gem_prior(self):
        s = self.rng.beta(1.0, self.gamma, size=self.K)
        s[-1] = 1.0
        psi = s * np.concatenate([[1.0], np.cumprod(1 - s[:-1])])
        return psi / psi.sum()

    def _phi_step(self):
        if self.use_ppu:
            varphi = self.rng.poisson(self.beta + self.n)
            rows = varphi.sum(axis=1, keepdims=True)
            phi = varphi / np.maximum(rows, 1)
        else:
            phi = self.rng.gamma(self.beta + self.n)
            phi /= phi.sum(axis=1, keepdims=True)
        return phi

    def _z_step(self):
        apsi = self.alpha * self.psi
        for d, (w_d, z_d) in enumerate(zip(self.docs, self.z)):
            m = np.bincount(z_d, minlength=self.K).astype(np.float64)
            for i in range(len(w_d)):
                m[z_d[i]] -= 1
                w = self.phi[:, w_d[i]] * (apsi + m)
                tot = w.sum()
                if tot > 0:  # zero-mass word: keep assignment
                    z_d[i] = self.rng.choice(self.K, p=w / tot)
                m[z_d[i]] += 1

    def _l_step(self):
        """Explicit b-sampling (eq. 26-27) — the thing the binomial trick
        replaces; kept as the distributional oracle."""
        l = np.zeros(self.K, dtype=np.int64)
        for z_d in self.z:
            m = np.bincount(z_d, minlength=self.K)
            for k in np.nonzero(m)[0]:
                for j in range(1, m[k] + 1):
                    p = self.psi[k] * self.alpha / (
                        self.psi[k] * self.alpha + j - 1
                    )
                    if self.rng.random() < p:
                        l[k] += 1
        return l

    def _psi_step(self, l):
        a = 1.0 + l
        tail = np.concatenate([np.cumsum(l[::-1])[::-1][1:], [0.0]])
        b = self.gamma + tail
        s = self.rng.beta(a, np.maximum(b, 1e-12))
        s[-1] = 1.0
        psi = s * np.concatenate([[1.0], np.cumprod(1 - s[:-1])])
        return psi / psi.sum()

    def iteration(self):
        self.phi = self._phi_step()
        self._z_step()
        self.n[:] = 0
        for d, zd in zip(self.docs, self.z):
            np.add.at(self.n, (zd, d), 1)
        l = self._l_step()
        self.psi = self._psi_step(l)

    def log_marginal_likelihood(self):
        ll = 0.0
        for w_d, z_d in zip(self.docs, self.z):
            m = np.zeros(self.K)
            for i in range(len(w_d)):
                zi = z_d[i]
                ll += np.log(max(self.phi[zi, w_d[i]], 1e-30))
                ll += np.log(
                    (self.alpha * self.psi[zi] + m[zi]) / (self.alpha + i)
                )
                m[zi] += 1
        return ll

    def active_topics(self):
        return int((self.n.sum(axis=1) > 0).sum())
