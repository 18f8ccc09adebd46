"""Direct-assignment HDP sampler (Teh et al. 2006), the paper's
small-scale baseline (Figure 1 a,b,d,e; counterpart of
``repro/core/direct_assignment.py``).

Fully collapsed: both theta_d and Phi integrated out; z_i sampled from

  P(z_i = k | ...) ∝ (m_dk^{-i} + alpha Psi_k) (n_{k,v}^{-i} + beta)
                                               / (n_k^{-i} + V beta)
  P(z_i = new)     ∝ alpha Psi_new / V

Psi is resampled from table counts drawn via the Chinese-restaurant
Antoniak scheme. Sequential by construction: this is the non-parallel
algorithm the paper's partially collapsed sampler replaces, kept in
numpy on the host as the convergence-comparison baseline. Every numpy
call comes in the reference's order, so one seed gives its arrays.
"""

from __future__ import annotations

import numpy as np


class DirectAssignmentHDP:
    def __init__(self, docs, V, K_max=200, alpha=0.1, beta=0.01, gamma=1.0,
                 seed=0):
        self.docs = [np.asarray(d, dtype=np.int64) for d in docs]
        self.V, self.K = V, K_max
        self.alpha, self.beta, self.gamma = alpha, beta, gamma
        self.rng = np.random.default_rng(seed)
        self.z = [np.zeros(len(d), dtype=np.int64) for d in self.docs]
        self.n = np.zeros((K_max, V), dtype=np.int64)
        self.nk = np.zeros(K_max, dtype=np.int64)
        self.m = np.zeros((len(docs), K_max), dtype=np.int64)
        for d, (w_d, z_d) in enumerate(zip(self.docs, self.z)):
            np.add.at(self.n, (z_d, w_d), 1)
            np.add.at(self.nk, z_d, 1)
            np.add.at(self.m[d], z_d, 1)
        self.psi = np.full(K_max, 1.0 / K_max)
        self._resample_psi()

    def _resample_psi(self):
        """Tables via Antoniak (CRF) draws, then stick-breaking posterior."""
        t = np.zeros(self.K, dtype=np.int64)
        for d in range(self.m.shape[0]):
            for k in np.nonzero(self.m[d])[0]:
                # number of tables serving dish k in restaurant d
                cnt = 0
                for j in range(1, self.m[d, k] + 1):
                    p = self.alpha * self.psi[k] / (
                        self.alpha * self.psi[k] + j - 1
                    )
                    cnt += self.rng.random() < p
                t[k] += cnt
        a = 1.0 + t
        tail = np.concatenate([np.cumsum(t[::-1])[::-1][1:], [0]])
        b = self.gamma + tail
        s = self.rng.beta(a, np.maximum(b, 1e-12))
        s[-1] = 1.0
        psi = s * np.concatenate([[1.0], np.cumprod(1 - s[:-1])])
        self.psi = psi / psi.sum()

    def iteration(self):
        vb = self.V * self.beta
        for d, (w_d, z_d) in enumerate(zip(self.docs, self.z)):
            for i in range(len(w_d)):
                k_old, v = z_d[i], w_d[i]
                self.n[k_old, v] -= 1
                self.nk[k_old] -= 1
                self.m[d, k_old] -= 1
                w = (self.m[d] + self.alpha * self.psi) * (
                    self.n[:, v] + self.beta
                ) / (self.nk + vb)
                w = np.maximum(w, 0)
                tot = w.sum()
                if tot <= 0:
                    k_new = k_old
                else:
                    k_new = self.rng.choice(self.K, p=w / tot)
                z_d[i] = k_new
                self.n[k_new, v] += 1
                self.nk[k_new] += 1
                self.m[d, k_new] += 1
        self._resample_psi()

    def log_marginal_likelihood(self):
        """Collapsed token likelihood (diagnostic; not comparable across
        parameterizations — the paper makes the same caveat)."""
        vb = self.V * self.beta
        ll = 0.0
        for w_d, z_d in zip(self.docs, self.z):
            for i in range(len(w_d)):
                k, v = z_d[i], w_d[i]
                ll += np.log((self.n[k, v] + self.beta) / (self.nk[k] + vb))
        return ll

    def active_topics(self):
        return int((self.nk > 0).sum())
