// Sequential Kalman filter and RTS smoother for small state dimensions, on
// the host: the state-space model's engine="cpp" (GPy's
// state_space_cython.pyx inner loops). The card's engines are the torch
// filters of gpy_tpu_torch/models/state_space.py; this loop is for
// evaluation on the CPU, where per-step dispatch of tiny (s x s) operations
// dominates a torch loop. It computes values only: no gradient.
//
// Built with g++ into gpy_tpu_torch/_build/libkalman.so at first use (a
// plain C interface, loaded by gpy_tpu_torch/ops/kalman_cpp.py with ctypes).
//
// Layout: all matrices row-major double. A, Q are (N-1, s, s) transition
// blocks per time gap; H is (1, s); P0 (s, s); ys (N).

#include <cmath>
#include <cstring>
#include <vector>

namespace {

// y = M x  (s x s times s)
inline void matvec(const double* M, const double* x, double* y, int s) {
    for (int i = 0; i < s; ++i) {
        double acc = 0.0;
        for (int j = 0; j < s; ++j) acc += M[i * s + j] * x[j];
        y[i] = acc;
    }
}

// C = A B  (s x s)
inline void matmul(const double* A, const double* B, double* C, int s) {
    for (int i = 0; i < s; ++i)
        for (int k = 0; k < s; ++k) {
            double a = A[i * s + k];
            for (int j = 0; j < s; ++j) C[i * s + j] += a * B[k * s + j];
        }
}

// C = A B^T (s x s)
inline void matmul_bt(const double* A, const double* B, double* C, int s) {
    for (int i = 0; i < s; ++i)
        for (int j = 0; j < s; ++j) {
            double acc = 0.0;
            for (int k = 0; k < s; ++k) acc += A[i * s + k] * B[j * s + k];
            C[i * s + j] = acc;
        }
}

// in-place Gauss-Jordan inverse with partial pivoting; returns 0 on success
int invert(double* M, double* Minv, int s) {
    std::vector<double> a(M, M + s * s);
    for (int i = 0; i < s * s; ++i) Minv[i] = 0.0;
    for (int i = 0; i < s; ++i) Minv[i * s + i] = 1.0;
    for (int col = 0; col < s; ++col) {
        int piv = col;
        double best = std::fabs(a[col * s + col]);
        for (int r = col + 1; r < s; ++r) {
            double v = std::fabs(a[r * s + col]);
            if (v > best) { best = v; piv = r; }
        }
        if (best < 1e-300) return 1;
        if (piv != col) {
            for (int j = 0; j < s; ++j) {
                std::swap(a[piv * s + j], a[col * s + j]);
                std::swap(Minv[piv * s + j], Minv[col * s + j]);
            }
        }
        double d = a[col * s + col];
        for (int j = 0; j < s; ++j) { a[col * s + j] /= d; Minv[col * s + j] /= d; }
        for (int r = 0; r < s; ++r) {
            if (r == col) continue;
            double f = a[r * s + col];
            if (f == 0.0) continue;
            for (int j = 0; j < s; ++j) {
                a[r * s + j] -= f * a[col * s + j];
                Minv[r * s + j] -= f * Minv[col * s + j];
            }
        }
    }
    return 0;
}

const double LOG_2_PI = 1.8378770664093453;

// one measurement update; returns per-point log-lik contribution
double update(double* m, double* P, const double* H, double y, double sigma2,
              int s, int observed) {
    if (!observed) return 0.0;
    // v = y - H m ; S = H P H' + sigma2 ; K = P H'/S
    double hm = 0.0;
    for (int j = 0; j < s; ++j) hm += H[j] * m[j];
    double v = y - hm;
    std::vector<double> PH(s, 0.0);
    for (int i = 0; i < s; ++i) {
        double acc = 0.0;
        for (int j = 0; j < s; ++j) acc += P[i * s + j] * H[j];
        PH[i] = acc;
    }
    double S = sigma2;
    for (int j = 0; j < s; ++j) S += H[j] * PH[j];
    for (int i = 0; i < s; ++i) m[i] += PH[i] * v / S;
    // P <- P - K (H P):  (H P)_j = PH_j by symmetry of P
    for (int i = 0; i < s; ++i)
        for (int j = 0; j < s; ++j) P[i * s + j] -= PH[i] * PH[j] / S;
    // symmetrize
    for (int i = 0; i < s; ++i)
        for (int j = i + 1; j < s; ++j) {
            double avg = 0.5 * (P[i * s + j] + P[j * s + i]);
            P[i * s + j] = avg;
            P[j * s + i] = avg;
        }
    return -0.5 * (LOG_2_PI + std::log(S) + v * v / S);
}

}  // namespace

extern "C" {

// Outputs: ms (N,s), Ps (N,s,s) filtered; mpreds (N,s), Ppreds (N,s,s)
// one-step predictions; loglik scalar. Returns 0 on success.
int kalman_filter(const double* A, const double* Q, const double* H,
                  const double* ys, const unsigned char* mask,
                  const double* P0, double sigma2, long N, int s,
                  double* ms, double* Ps, double* mpreds, double* Ppreds,
                  double* loglik) {
    std::vector<double> m(s, 0.0), P(P0, P0 + s * s), tmp(s), TP(s * s);
    double ll = 0.0;
    // first step: predict == prior
    std::memset(mpreds, 0, sizeof(double) * s);
    std::memcpy(Ppreds, P0, sizeof(double) * s * s);
    ll += update(m.data(), P.data(), H, ys[0], sigma2, s, mask[0]);
    std::memcpy(ms, m.data(), sizeof(double) * s);
    std::memcpy(Ps, P.data(), sizeof(double) * s * s);
    for (long n = 1; n < N; ++n) {
        const double* An = A + (n - 1) * s * s;
        const double* Qn = Q + (n - 1) * s * s;
        // m_pred = A m ; P_pred = A P A' + Q
        matvec(An, m.data(), tmp.data(), s);
        std::memcpy(m.data(), tmp.data(), sizeof(double) * s);
        std::memset(TP.data(), 0, sizeof(double) * s * s);
        matmul(An, P.data(), TP.data(), s);  // TP = A P
        matmul_bt(TP.data(), An, P.data(), s);  // P = (A P) A'
        for (int i = 0; i < s * s; ++i) P[i] += Qn[i];
        std::memcpy(mpreds + n * s, m.data(), sizeof(double) * s);
        std::memcpy(Ppreds + n * s * s, P.data(), sizeof(double) * s * s);
        ll += update(m.data(), P.data(), H, ys[n], sigma2, s, mask[n]);
        std::memcpy(ms + n * s, m.data(), sizeof(double) * s);
        std::memcpy(Ps + n * s * s, P.data(), sizeof(double) * s * s);
    }
    *loglik = ll;
    return 0;
}

// RTS smoother over the filter outputs; ms_s (N,s), Ps_s (N,s,s).
int rts_smoother(const double* ms, const double* Ps, const double* mpreds,
                 const double* Ppreds, const double* A, long N, int s,
                 double* ms_s, double* Ps_s) {
    std::memcpy(ms_s + (N - 1) * s, ms + (N - 1) * s, sizeof(double) * s);
    std::memcpy(Ps_s + (N - 1) * s * s, Ps + (N - 1) * s * s, sizeof(double) * s * s);
    std::vector<double> Pinv(s * s), G(s * s), PA(s * s), dm(s), dP(s * s), GT(s * s);
    for (long n = N - 2; n >= 0; --n) {
        const double* An = A + n * s * s;  // transition n -> n+1
        const double* Ppn = Ppreds + (n + 1) * s * s;
        std::vector<double> Pp(Ppn, Ppn + s * s);
        for (int i = 0; i < s; ++i) Pp[i * s + i] += 1e-12;
        if (invert(Pp.data(), Pinv.data(), s)) return 1;
        // G = P_f A' Pinv
        matmul_bt(Ps + n * s * s, An, PA.data(), s);  // PA = P_f A'
        std::memset(G.data(), 0, sizeof(double) * s * s);
        matmul(PA.data(), Pinv.data(), G.data(), s);
        // m_s = m_f + G (m_next_s - m_pred_next)
        for (int i = 0; i < s; ++i)
            dm[i] = ms_s[(n + 1) * s + i] - mpreds[(n + 1) * s + i];
        matvec(G.data(), dm.data(), dP.data(), s);  // reuse dP[0..s) as vector
        for (int i = 0; i < s; ++i) ms_s[n * s + i] = ms[n * s + i] + dP[i];
        // P_s = P_f + G (P_next_s - P_pred_next) G'
        for (int i = 0; i < s * s; ++i)
            dP[i] = Ps_s[(n + 1) * s * s + i] - Ppn[i];
        std::memset(GT.data(), 0, sizeof(double) * s * s);
        matmul(G.data(), dP.data(), GT.data(), s);   // GT = G dP
        matmul_bt(GT.data(), G.data(), dP.data(), s);  // dP = (G dP) G'
        for (int i = 0; i < s * s; ++i)
            Ps_s[n * s * s + i] = Ps[n * s * s + i] + dP[i];
    }
    return 0;
}

}  // extern "C"
