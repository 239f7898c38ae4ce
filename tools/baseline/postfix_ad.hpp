// Postfix-AD model evaluation for the baseline harness: replaces ASL
// behind the reference's Model seam (AMPLModel.cpp:19-80) so the ACTUAL
// reference binary can sweep the same .nl corpus the JAX framework uses
// (round-4 verdict item 1: a measured reference-side denominator for the
// CUTEst parity claim).
//
// The .nl files are parsed by /root/repo/uno_tpu/io/nlread.cpp (compiled
// into this binary; NLData layout must stay in sync with the struct in
// that file's extern "C" block).  Each constraint/objective expression
// arrives as a postfix token stream; this header decodes it once into an
// SSA node array and provides:
//   * value evaluation,
//   * reverse-mode gradients (one sweep per expression),
//   * Hessian-vector products by forward-over-reverse (tangent-carrying
//     reverse sweep), assembled into dense Lagrangian Hessians column by
//     column over each expression's variable support.
//
// Opcode coverage is the smooth ASL subset the jaxpr->.nl transcriber
// emits (+ abs/min/max/if with one-sided derivatives, matching ASL's own
// nonsmooth-evaluation behavior).

#pragma once

#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <stdexcept>
#include <string>
#include <vector>

extern "C" {

// keep in sync with uno_tpu/io/nlread.cpp
struct NLData {
    int32_t n_vars, n_cons, n_objs, n_defined;
    int32_t objective_sense;
    double *x_lb, *x_ub, *c_lb, *c_ub, *x0, *y0;
    int32_t jac_nnz; int32_t *jac_row, *jac_col; double* jac_val;
    int32_t grad_nnz; int32_t *grad_col; double* grad_val;
    int32_t n_tokens; int32_t* tok_op; double* tok_num;
    int32_t *con_expr_off;
    int32_t *obj_expr_off;
    int32_t *def_expr_off;
    int32_t *def_index;
    int32_t deflin_nnz; int32_t *deflin_def, *deflin_col; double* deflin_val;
    char error[512];
};

NLData* nl_parse(const char* path);
void nl_free(NLData* d);

}  // extern "C"

namespace nlad {

struct Node {
    int32_t op;        // ASL opcode; -1 const; -2 variable
    int32_t a{-1}, b{-1}, c{-1};   // operand node ids
    double num{0.0};   // constant value / variable index
    int32_t args_off{0}, nargs{0}; // for list ops (11/12/54)
};

struct Prog {
    std::vector<Node> nodes;
    std::vector<int32_t> arglist;
    std::vector<int32_t> vars;     // sorted unique variable indices
    int32_t root{-1};

    // workspaces (resized on first use)
    mutable std::vector<double> val, dot, bar, dbar;
};

inline Prog decode(const int32_t* ops, const double* nums, int32_t count) {
    Prog p;
    std::vector<int32_t> stack;
    std::vector<char> seen_var;
    p.nodes.reserve(count);
    for (int32_t i = 0; i < count; ++i) {
        Node n;
        n.op = ops[i];
        n.num = nums[i];
        const int32_t id = static_cast<int32_t>(p.nodes.size());
        switch (n.op) {
            case -1: break;
            case -2: {
                const int32_t vi = static_cast<int32_t>(n.num);
                if (vi >= static_cast<int32_t>(seen_var.size()))
                    seen_var.resize(vi + 1, 0);
                seen_var[vi] = 1;
                break;
            }
            case 11: case 12: case 54: {      // min/max/sum lists
                const int32_t k = static_cast<int32_t>(n.num);
                n.nargs = k;
                n.args_off = static_cast<int32_t>(p.arglist.size());
                p.arglist.resize(n.args_off + k);
                for (int32_t j = k - 1; j >= 0; --j) {
                    p.arglist[n.args_off + j] = stack.back();
                    stack.pop_back();
                }
                break;
            }
            case 35: {                        // if-then-else
                n.c = stack.back(); stack.pop_back();
                n.b = stack.back(); stack.pop_back();
                n.a = stack.back(); stack.pop_back();
                break;
            }
            // unary
            case 13: case 14: case 15: case 16: case 34: case 37: case 38:
            case 39: case 40: case 41: case 42: case 43: case 44: case 45:
            case 46: case 47: case 49: case 50: case 51: case 52: case 53:
            case 77:
                n.a = stack.back(); stack.pop_back();
                break;
            // binary
            case 0: case 1: case 2: case 3: case 4: case 5: case 6:
            case 20: case 21: case 22: case 23: case 24: case 28: case 29:
            case 30: case 48: case 55:
                n.b = stack.back(); stack.pop_back();
                n.a = stack.back(); stack.pop_back();
                break;
            default:
                throw std::runtime_error("postfix_ad: unsupported opcode o"
                                         + std::to_string(n.op));
        }
        p.nodes.push_back(n);
        stack.push_back(id);
    }
    if (stack.size() != 1)
        throw std::runtime_error("postfix_ad: malformed program");
    p.root = stack.back();
    for (int32_t v = 0; v < static_cast<int32_t>(seen_var.size()); ++v)
        if (seen_var[v]) p.vars.push_back(v);
    return p;
}

// forward pass: values (always) and tangents d/dt at x + t*dir (when
// dir_var >= 0, tangent of that single variable = 1; dir_var == -1 skips
// tangent work entirely)
inline void forward(const Prog& p, const double* x, int dir_var) {
    const size_t N = p.nodes.size();
    p.val.resize(N);
    const bool tg = dir_var >= 0;
    if (tg) p.dot.assign(N, 0.0);
    for (size_t i = 0; i < N; ++i) {
        const Node& n = p.nodes[i];
        double v = 0.0, d = 0.0;
        const double va = n.a >= 0 ? p.val[n.a] : 0.0;
        const double vb = n.b >= 0 ? p.val[n.b] : 0.0;
        const double da = (tg && n.a >= 0) ? p.dot[n.a] : 0.0;
        const double db = (tg && n.b >= 0) ? p.dot[n.b] : 0.0;
        switch (n.op) {
            case -1: v = n.num; break;
            case -2: {
                const int vi = static_cast<int>(n.num);
                v = x[vi];
                d = (tg && vi == dir_var) ? 1.0 : 0.0;
                break;
            }
            case 0: v = va + vb; d = da + db; break;
            case 1: v = va - vb; d = da - db; break;
            case 2: v = va * vb; d = da * vb + va * db; break;
            case 3: v = va / vb; d = (da - (va / vb) * db) / vb; break;
            case 4: v = std::fmod(va, vb); d = da; break;   // rem (db=0 use)
            case 5: {
                v = std::pow(va, vb);
                if (db != 0.0)
                    throw std::runtime_error("postfix_ad: pow with varying "
                                             "exponent unsupported");
                d = (da == 0.0) ? 0.0 : vb * std::pow(va, vb - 1.0) * da;
                break;
            }
            case 6: v = std::fmax(va - vb, 0.0);            // less
                d = (va - vb > 0.0) ? da - db : 0.0; break;
            case 13: v = std::floor(va); d = 0.0; break;
            case 14: v = std::ceil(va); d = 0.0; break;
            case 15: v = std::fabs(va); d = (va >= 0.0 ? da : -da); break;
            case 16: v = -va; d = -da; break;
            case 37: v = std::tanh(va); d = (1.0 - v * v) * da; break;
            case 38: v = std::tan(va); d = (1.0 + v * v) * da; break;
            case 39: v = std::sqrt(va); d = da / (2.0 * v); break;
            case 40: v = std::sinh(va); d = std::cosh(va) * da; break;
            case 41: v = std::sin(va); d = std::cos(va) * da; break;
            case 42: v = std::log10(va); d = da / (va * 2.302585092994046);
                break;
            case 43: v = std::log(va); d = da / va; break;
            case 44: v = std::exp(va); d = v * da; break;
            case 45: v = std::cosh(va); d = std::sinh(va) * da; break;
            case 46: v = std::cos(va); d = -std::sin(va) * da; break;
            case 47: v = std::atanh(va); d = da / (1.0 - va * va); break;
            case 48: v = std::atan2(va, vb);
                d = (da * vb - va * db) / (va * va + vb * vb); break;
            case 49: v = std::atan(va); d = da / (1.0 + va * va); break;
            case 50: v = std::asinh(va); d = da / std::sqrt(va * va + 1.0);
                break;
            case 51: v = std::asin(va); d = da / std::sqrt(1.0 - va * va);
                break;
            case 52: v = std::acosh(va); d = da / std::sqrt(va * va - 1.0);
                break;
            case 53: v = std::acos(va); d = -da / std::sqrt(1.0 - va * va);
                break;
            case 77: v = va * va; d = 2.0 * va * da; break;
            case 54: {
                for (int32_t j = 0; j < n.nargs; ++j) {
                    const int32_t cidx = p.arglist[n.args_off + j];
                    v += p.val[cidx];
                    if (tg) d += p.dot[cidx];
                }
                break;
            }
            case 11: case 12: {
                int32_t best = p.arglist[n.args_off];
                for (int32_t j = 1; j < n.nargs; ++j) {
                    const int32_t cidx = p.arglist[n.args_off + j];
                    const bool better = (n.op == 11)
                        ? p.val[cidx] < p.val[best]
                        : p.val[cidx] > p.val[best];
                    if (better) best = cidx;
                }
                v = p.val[best];
                if (tg) d = p.dot[best];
                break;
            }
            case 35:
                v = (va != 0.0) ? vb : p.val[n.c];
                if (tg) d = (va != 0.0) ? db : p.dot[n.c];
                break;
            // comparisons / logic (inside o35 conditions): 0/1 values
            case 20: v = (va != 0.0 || vb != 0.0) ? 1.0 : 0.0; break;
            case 21: v = (va != 0.0 && vb != 0.0) ? 1.0 : 0.0; break;
            case 22: v = (va < vb) ? 1.0 : 0.0; break;
            case 23: v = (va <= vb) ? 1.0 : 0.0; break;
            case 24: v = (va == vb) ? 1.0 : 0.0; break;
            case 28: v = (va >= vb) ? 1.0 : 0.0; break;
            case 29: v = (va > vb) ? 1.0 : 0.0; break;
            case 30: v = (va != vb) ? 1.0 : 0.0; break;
            case 34: v = (va == 0.0) ? 1.0 : 0.0; break;
            case 55: v = std::trunc(va / vb); d = 0.0; break;
            default:
                throw std::runtime_error("postfix_ad: eval opcode o"
                                         + std::to_string(n.op));
        }
        p.val[i] = v;
        if (tg) p.dot[i] = d;
    }
}

// reverse pass.  weight seeds the root adjoint.  When `second` is true the
// tangent-carrying adjoint (dbar) is propagated as well and accumulated
// into hv[] — forward() must have been called with the matching dir_var.
// grad may be null (Hessian-only sweeps still need bar for the chain rule).
inline void reverse(const Prog& p, double weight, double* grad,
                    bool second, double* hv) {
    const size_t N = p.nodes.size();
    p.bar.assign(N, 0.0);
    if (second) p.dbar.assign(N, 0.0);
    p.bar[p.root] = weight;
    for (size_t ii = N; ii-- > 0;) {
        const Node& n = p.nodes[ii];
        const double w = p.bar[ii];
        const double dw = second ? p.dbar[ii] : 0.0;
        if (w == 0.0 && dw == 0.0 && n.op != -2) continue;
        const double va = n.a >= 0 ? p.val[n.a] : 0.0;
        const double vb = n.b >= 0 ? p.val[n.b] : 0.0;
        const double da = (second && n.a >= 0) ? p.dot[n.a] : 0.0;
        const double db = (second && n.b >= 0) ? p.dot[n.b] : 0.0;
        switch (n.op) {
            case -1: break;
            case -2: {
                const int vi = static_cast<int>(n.num);
                if (grad) grad[vi] += w;
                if (second && hv) hv[vi] += dw;
                break;
            }
            case 0:
                p.bar[n.a] += w; p.bar[n.b] += w;
                if (second) { p.dbar[n.a] += dw; p.dbar[n.b] += dw; }
                break;
            case 1:
                p.bar[n.a] += w; p.bar[n.b] -= w;
                if (second) { p.dbar[n.a] += dw; p.dbar[n.b] -= dw; }
                break;
            case 2:
                p.bar[n.a] += vb * w; p.bar[n.b] += va * w;
                if (second) {
                    p.dbar[n.a] += vb * dw + db * w;
                    p.dbar[n.b] += va * dw + da * w;
                }
                break;
            case 3: {
                const double inv = 1.0 / vb;
                const double fa = inv;                // d/da
                const double fb = -va * inv * inv;    // d/db
                p.bar[n.a] += fa * w; p.bar[n.b] += fb * w;
                if (second) {
                    // f_aa = 0; f_ab = -1/b^2; f_bb = 2a/b^3
                    const double fab = -inv * inv;
                    const double fbb = 2.0 * va * inv * inv * inv;
                    p.dbar[n.a] += fa * dw + w * (fab * db);
                    p.dbar[n.b] += fb * dw + w * (fab * da + fbb * db);
                }
                break;
            }
            case 5: {
                const double pe = vb;   // constant exponent (checked fwd)
                const double fa = pe * std::pow(va, pe - 1.0);
                p.bar[n.a] += fa * w;
                if (second) {
                    const double faa = pe * (pe - 1.0)
                        * std::pow(va, pe - 2.0);
                    p.dbar[n.a] += fa * dw + w * faa * da;
                }
                break;
            }
            case 6: {   // less: max(a-b, 0)
                const double g = (va - vb > 0.0) ? 1.0 : 0.0;
                p.bar[n.a] += g * w; p.bar[n.b] -= g * w;
                if (second) { p.dbar[n.a] += g * dw; p.dbar[n.b] -= g * dw; }
                break;
            }
            case 13: case 14: break;   // floor/ceil: zero derivative
            case 15: {
                const double s = (va >= 0.0) ? 1.0 : -1.0;
                p.bar[n.a] += s * w;
                if (second) p.dbar[n.a] += s * dw;
                break;
            }
            case 16:
                p.bar[n.a] -= w;
                if (second) p.dbar[n.a] -= dw;
                break;
            case 37: {   // tanh: f' = 1 - t^2, f'' = -2 t (1 - t^2)
                const double t = p.val[ii];
                const double fa = 1.0 - t * t;
                p.bar[n.a] += fa * w;
                if (second)
                    p.dbar[n.a] += fa * dw + w * (-2.0 * t * fa) * da;
                break;
            }
            case 38: {   // tan: f' = 1 + t^2; f'' = 2 t (1 + t^2)
                const double t = p.val[ii];
                const double fa = 1.0 + t * t;
                p.bar[n.a] += fa * w;
                if (second)
                    p.dbar[n.a] += fa * dw + w * (2.0 * t * fa) * da;
                break;
            }
            case 39: {   // sqrt: f' = 1/(2 s); f'' = -1/(4 s^3)
                const double s = p.val[ii];
                const double fa = 0.5 / s;
                p.bar[n.a] += fa * w;
                if (second)
                    p.dbar[n.a] += fa * dw + w * (-0.25 / (s * s * s)) * da;
                break;
            }
            case 40: {   // sinh
                const double fa = std::cosh(va);
                p.bar[n.a] += fa * w;
                if (second)
                    p.dbar[n.a] += fa * dw + w * p.val[ii] * da;
                break;
            }
            case 41: {   // sin
                const double fa = std::cos(va);
                p.bar[n.a] += fa * w;
                if (second)
                    p.dbar[n.a] += fa * dw + w * (-p.val[ii]) * da;
                break;
            }
            case 42: {   // log10
                const double fa = 1.0 / (va * 2.302585092994046);
                p.bar[n.a] += fa * w;
                if (second)
                    p.dbar[n.a] += fa * dw + w * (-fa / va) * da;
                break;
            }
            case 43: {   // log
                const double fa = 1.0 / va;
                p.bar[n.a] += fa * w;
                if (second)
                    p.dbar[n.a] += fa * dw + w * (-fa * fa) * da;
                break;
            }
            case 44: {   // exp
                const double fa = p.val[ii];
                p.bar[n.a] += fa * w;
                if (second)
                    p.dbar[n.a] += fa * dw + w * fa * da;
                break;
            }
            case 45: {   // cosh
                const double fa = std::sinh(va);
                p.bar[n.a] += fa * w;
                if (second)
                    p.dbar[n.a] += fa * dw + w * p.val[ii] * da;
                break;
            }
            case 46: {   // cos
                const double fa = -std::sin(va);
                p.bar[n.a] += fa * w;
                if (second)
                    p.dbar[n.a] += fa * dw + w * (-p.val[ii]) * da;
                break;
            }
            case 47: {   // atanh: f' = 1/(1-a^2); f'' = 2a/(1-a^2)^2
                const double q = 1.0 - va * va;
                const double fa = 1.0 / q;
                p.bar[n.a] += fa * w;
                if (second)
                    p.dbar[n.a] += fa * dw + w * (2.0 * va * fa * fa) * da;
                break;
            }
            case 49: {   // atan: f' = 1/(1+a^2); f'' = -2a/(1+a^2)^2
                const double q = 1.0 + va * va;
                const double fa = 1.0 / q;
                p.bar[n.a] += fa * w;
                if (second)
                    p.dbar[n.a] += fa * dw + w * (-2.0 * va * fa * fa) * da;
                break;
            }
            case 50: {   // asinh: f' = 1/sqrt(a^2+1)
                const double q = std::sqrt(va * va + 1.0);
                const double fa = 1.0 / q;
                p.bar[n.a] += fa * w;
                if (second)
                    p.dbar[n.a] += fa * dw
                        + w * (-va / (q * q * q)) * da;
                break;
            }
            case 51: {   // asin: f' = 1/sqrt(1-a^2); f'' = a/(1-a^2)^1.5
                const double q = std::sqrt(1.0 - va * va);
                const double fa = 1.0 / q;
                p.bar[n.a] += fa * w;
                if (second)
                    p.dbar[n.a] += fa * dw + w * (va / (q * q * q)) * da;
                break;
            }
            case 52: {   // acosh
                const double q = std::sqrt(va * va - 1.0);
                const double fa = 1.0 / q;
                p.bar[n.a] += fa * w;
                if (second)
                    p.dbar[n.a] += fa * dw + w * (-va / (q * q * q)) * da;
                break;
            }
            case 53: {   // acos
                const double q = std::sqrt(1.0 - va * va);
                const double fa = -1.0 / q;
                p.bar[n.a] += fa * w;
                if (second)
                    p.dbar[n.a] += fa * dw + w * (-va / (q * q * q)) * da;
                break;
            }
            case 48: {   // atan2(a, b)
                const double q = va * va + vb * vb;
                const double fa = vb / q, fb = -va / q;
                p.bar[n.a] += fa * w; p.bar[n.b] += fb * w;
                if (second) {
                    const double faa = -2.0 * va * vb / (q * q);
                    const double fab = (va * va - vb * vb) / (q * q);
                    const double fbb = 2.0 * va * vb / (q * q);
                    p.dbar[n.a] += fa * dw + w * (faa * da + fab * db);
                    p.dbar[n.b] += fb * dw + w * (fab * da + fbb * db);
                }
                break;
            }
            case 77: {   // a^2
                p.bar[n.a] += 2.0 * va * w;
                if (second)
                    p.dbar[n.a] += 2.0 * va * dw + w * 2.0 * da;
                break;
            }
            case 54:
                for (int32_t j = 0; j < n.nargs; ++j) {
                    const int32_t cidx = p.arglist[n.args_off + j];
                    p.bar[cidx] += w;
                    if (second) p.dbar[cidx] += dw;
                }
                break;
            case 11: case 12: {
                int32_t best = p.arglist[n.args_off];
                for (int32_t j = 1; j < n.nargs; ++j) {
                    const int32_t cidx = p.arglist[n.args_off + j];
                    const bool better = (n.op == 11)
                        ? p.val[cidx] < p.val[best]
                        : p.val[cidx] > p.val[best];
                    if (better) best = cidx;
                }
                p.bar[best] += w;
                if (second) p.dbar[best] += dw;
                break;
            }
            case 35: {
                const int32_t taken = (va != 0.0) ? n.b : n.c;
                p.bar[taken] += w;
                if (second) p.dbar[taken] += dw;
                break;
            }
            case 20: case 21: case 22: case 23: case 24: case 28: case 29:
            case 30: case 34: case 55:
                break;   // zero derivative
            default:
                throw std::runtime_error("postfix_ad: reverse opcode o"
                                         + std::to_string(n.op));
        }
    }
}

}  // namespace nlad
