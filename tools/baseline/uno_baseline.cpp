// Baseline measurement harness: runs the REFERENCE Uno driver (libuno from
// /root/reference, built in this container with no Fortran solvers available)
// against hand-coded analytic models, using a LAPACK dsytrf/dsytrs dense
// LDL^T as the symmetric-indefinite linear solver (the MA27/MA57 seam,
// DirectSymmetricIndefiniteLinearSolver.hpp:12-26).
//
// Purpose: produce a MEASURED single-core reference baseline for BASELINE.md
// (solves/s on the bench flagship family; iteration traces on hs015/polak5)
// instead of the round-1 guess. This file is a measurement harness ONLY —
// it is not part of the uno_tpu framework and links against the reference's
// headers/objects; the solver orchestration sequence in
// solve_indefinite_system(Statistics&,...) is dictated by the reference's
// Subproblem API (Subproblem.hpp:29-76, same sequence as MA57Solver.cpp:155-179).
//
// Build: tools/baseline/build.sh  (g++ + liblapack; no Fortran needed)
// Run:   uno_baseline hs015 [preset=ipopt key=value ...]
//        uno_baseline flagship_bench <n_instances> [key=value ...]

#include <algorithm>
#include <chrono>
#include <cmath>
#include <cstring>
#include <filesystem>
#include <iostream>
#include <memory>
#include <random>
#include <string>
#include <vector>

#include "ipqp.hpp"
#include "postfix_ad.hpp"

#include "Uno.hpp"
#include "ingredients/hessian_models/HessianModel.hpp"
#include "ingredients/regularization_strategies/RegularizationStrategy.hpp"
#include "optimization/OptimizationProblem.hpp"
#include "ingredients/subproblem/Subproblem.hpp"
#include "ingredients/subproblem_solvers/LPSolver.hpp"
#include "ingredients/subproblem_solvers/LPSolverFactory.hpp"
#include "ingredients/subproblem_solvers/QPSolver.hpp"
#include "ingredients/subproblem_solvers/QPSolverFactory.hpp"
#include "optimization/Multipliers.hpp"
#include "ingredients/subproblem_solvers/DirectSymmetricIndefiniteLinearSolver.hpp"
#include "ingredients/subproblem_solvers/SymmetricIndefiniteLinearSolverFactory.hpp"
#include "linear_algebra/COOFormat.hpp"
#include "linear_algebra/RectangularMatrix.hpp"
#include "linear_algebra/SparseSymmetricMatrix.hpp"
#include "linear_algebra/SparseVector.hpp"
#include "linear_algebra/SymmetricMatrix.hpp"
#include "linear_algebra/Vector.hpp"
#include "model/Model.hpp"
#include "model/ModelFactory.hpp"
#include "optimization/Direction.hpp"
#include "optimization/Iterate.hpp"
#include "optimization/OptimizationStatus.hpp"
#include "optimization/Result.hpp"
#include "optimization/WarmstartInformation.hpp"
#include "options/DefaultOptions.hpp"
#include "options/Options.hpp"
#include "options/Presets.hpp"
#include "symbolic/CollectionAdapter.hpp"
#include "symbolic/Range.hpp"
#include "tools/Infinity.hpp"
#include "tools/Logger.hpp"
#include "tools/Statistics.hpp"
#include "tools/UserCallbacks.hpp"

extern "C" {
void dsytrf_(const char* uplo, const int* n, double* a, const int* lda, int* ipiv,
             double* work, const int* lwork, int* info);
void dsytrs_(const char* uplo, const int* n, const int* nrhs, const double* a,
             const int* lda, const int* ipiv, double* b, const int* ldb, int* info);
}

namespace uno {

// ---------------------------------------------------------------------------
// LAPACK dense LDL^T with inertia (stands in for MA27/MA57 behind the
// DirectSymmetricIndefiniteLinearSolver seam)
// ---------------------------------------------------------------------------
class LapackLDLTSolver : public DirectSymmetricIndefiniteLinearSolver<size_t, double> {
public:
   LapackLDLTSolver() = default;

   void initialize_memory(size_t number_variables, size_t number_constraints,
         size_t number_hessian_nonzeros, size_t regularization_size) override {
      const size_t dim = number_variables + number_constraints;
      this->dim_alloc = dim;
      this->dense.resize(dim * dim);
      this->factors.resize(dim * dim);
      this->ipiv.resize(dim);
      this->work.resize(64 * dim + 64);
      this->objective_gradient.resize(number_variables);
      this->constraints.resize(number_constraints);
      this->constraint_jacobian.resize(number_constraints, number_variables);
      this->augmented_matrix = SparseSymmetricMatrix<COOFormat<size_t, double>>(
         dim, number_hessian_nonzeros, regularization_size);
      this->rhs.resize(dim);
      this->solution.resize(dim);
   }

   void do_symbolic_analysis(const SymmetricMatrix<size_t, double>& matrix) override {
      this->n = static_cast<int>(matrix.dimension());
   }

   void do_numerical_factorization(const SymmetricMatrix<size_t, double>& matrix) override {
      this->n = static_cast<int>(matrix.dimension());
      const size_t nd = static_cast<size_t>(this->n);
      std::fill(this->dense.begin(), this->dense.begin() + nd * nd, 0.0);
      // scatter COO (duplicates sum, MA57 convention); store lower triangle
      for (const auto [row, col, value] : matrix) {
         const size_t i = std::max(row, col), j = std::min(row, col);
         this->dense[j * nd + i] += value;
      }
      std::memcpy(this->factors.data(), this->dense.data(), nd * nd * sizeof(double));
      int info = 0;
      const int lwork = static_cast<int>(this->work.size());
      const char uplo = 'L';
      dsytrf_(&uplo, &this->n, this->factors.data(), &this->n, this->ipiv.data(),
              this->work.data(), &lwork, &info);
      this->compute_inertia(info);
   }

   void solve_indefinite_system(const SymmetricMatrix<size_t, double>& matrix,
         const Vector<double>& rhs_in, Vector<double>& result) override {
      const int nrhs = 1;
      result = rhs_in;
      int info = 0;
      const char uplo = 'L';
      dsytrs_(&uplo, &this->n, &nrhs, this->factors.data(), &this->n,
              this->ipiv.data(), result.data(), &this->n, &info);
   }

   // full per-iteration orchestration behind the linear-solver seam; the
   // sequence (evaluate -> assemble -> regularize -> rhs -> solve -> direction)
   // is fixed by the Subproblem API
   void solve_indefinite_system(Statistics& statistics, const Subproblem& subproblem,
         Direction& direction, const WarmstartInformation& warmstart_information) override {
      if (warmstart_information.objective_changed) {
         subproblem.evaluate_objective_gradient(this->objective_gradient);
      }
      if (warmstart_information.constraints_changed) {
         subproblem.evaluate_constraints(this->constraints);
         subproblem.evaluate_jacobian(this->constraint_jacobian);
      }
      if (warmstart_information.objective_changed || warmstart_information.constraints_changed) {
         this->augmented_matrix.reset();
         subproblem.assemble_augmented_matrix(statistics, this->augmented_matrix,
            this->constraint_jacobian);
         subproblem.regularize_augmented_matrix(statistics, this->augmented_matrix,
            subproblem.dual_regularization_factor(), *this);
         subproblem.assemble_augmented_rhs(this->objective_gradient, this->constraints,
            this->constraint_jacobian, this->rhs);
      }
      this->solve_indefinite_system(this->augmented_matrix, this->rhs, this->solution);
      subproblem.assemble_primal_dual_direction(this->solution, direction);
   }

   [[nodiscard]] Inertia get_inertia() const override {
      return {this->n_pos, this->n_neg, this->n_zero};
   }
   [[nodiscard]] size_t number_negative_eigenvalues() const override { return this->n_neg; }
   [[nodiscard]] bool matrix_is_singular() const override { return this->singular; }
   [[nodiscard]] size_t rank() const override { return this->n_pos + this->n_neg; }

private:
   int n{0};
   size_t dim_alloc{0};
   std::vector<double> dense, factors, work;
   std::vector<int> ipiv;
   size_t n_pos{0}, n_neg{0}, n_zero{0};
   bool singular{false};

   // evaluation + augmented-system buffers (same layout as the MA57 wrapper)
   Vector<double> objective_gradient;
   std::vector<double> constraints;
   RectangularMatrix<double> constraint_jacobian;
   SparseSymmetricMatrix<COOFormat<size_t, double>> augmented_matrix{};
   Vector<double> rhs{}, solution{};

   void compute_inertia(int lapack_info) {
      // walk the block-diagonal D of the Bunch-Kaufman factorization:
      // ipiv[k] > 0 -> 1x1 pivot d = F(k,k); consecutive negative ipiv pair
      // -> 2x2 block [[a,b],[b,c]] with b = F(k+1,k) (uplo='L')
      this->n_pos = this->n_neg = this->n_zero = 0;
      this->singular = (lapack_info > 0);
      const size_t nd = static_cast<size_t>(this->n);
      size_t k = 0;
      while (k < nd) {
         if (this->ipiv[k] > 0) {
            const double d = this->factors[k * nd + k];
            if (d > 0.0) { this->n_pos++; }
            else if (d < 0.0) { this->n_neg++; }
            else { this->n_zero++; }
            k++;
         }
         else {
            const double a = this->factors[k * nd + k];
            const double c = this->factors[(k + 1) * nd + (k + 1)];
            const double b = this->factors[k * nd + (k + 1)];
            // eigenvalues of the symmetric 2x2: both roots of
            // lambda^2 - (a+c) lambda + (ac - b^2)
            const double mean = 0.5 * (a + c);
            const double radius = std::sqrt(std::max(0.0, mean * mean - (a * c - b * b)));
            for (const double lambda : {mean + radius, mean - radius}) {
               if (lambda > 0.0) { this->n_pos++; }
               else if (lambda < 0.0) { this->n_neg++; }
               else { this->n_zero++; }
            }
            k += 2;
         }
      }
      if (this->n_zero > 0) { this->singular = true; }
   }
};

// ---------------------------------------------------------------------------
// IP-QP/LP solver behind the reference QPSolver/LPSolver seam (stands in
// for BQPD/HiGHS, which do not exist in this container); algorithm in
// ipqp.hpp mirrors uno_tpu/solvers/qp.py.  Lets the reference driver run
// its SQP presets (filtersqp/funnelsqp/byrd/filterslp) on the .nl corpus.
// ---------------------------------------------------------------------------
class IPQPSolver : public QPSolver {
public:
   IPQPSolver() = default;

   void initialize_memory(const OptimizationProblem& problem, const HessianModel& hessian_model,
         const RegularizationStrategy<double>& regularization_strategy) override {
      const size_t n = problem.number_variables;
      const size_t m = problem.number_constraints;
      this->n = n; this->m = m;
      this->g.resize(n);
      this->H.assign(n * n, 0.0);
      this->Jd.assign(m * n, 0.0);
      this->dl.resize(n); this->du.resize(n);
      this->rl.resize(m); this->ru.resize(m);
      this->constraints.resize(m);
      this->constraint_jacobian.resize(m, n);
      const size_t number_hessian_nonzeros = problem.number_hessian_nonzeros(hessian_model);
      const size_t regularization_size = (!hessian_model.is_positive_definite() &&
         regularization_strategy.performs_primal_regularization()) ? problem.get_number_original_variables() : 0;
      this->has_curvature = 0 < number_hessian_nonzeros + regularization_size;
      if (this->has_curvature) {
         this->hessian = SparseSymmetricMatrix<COOFormat<size_t, double>>(
            n, number_hessian_nonzeros, regularization_size);
      }
      this->out_d.resize(n); this->out_y.resize(std::max<size_t>(m, 1));
      this->out_zl.resize(n); this->out_zu.resize(n);
   }

   void solve(Statistics& statistics, Subproblem& subproblem, const Vector<double>& /*initial_point*/,
         Direction& direction, const WarmstartInformation& /*warmstart_information*/) override {
      const int ni = static_cast<int>(this->n), mi = static_cast<int>(this->m);
      // evaluate everything fresh each solve (an IP method has no
      // active-set warmstart economics to protect)
      subproblem.evaluate_objective_gradient(this->g);
      subproblem.evaluate_constraints(this->constraints);
      subproblem.evaluate_jacobian(this->constraint_jacobian);
      std::fill(this->Jd.begin(), this->Jd.end(), 0.0);
      for (size_t j = 0; j < this->m; ++j) {
         for (const auto [i, value] : this->constraint_jacobian[j]) {
            this->Jd[j * this->n + i] = value;
         }
      }
      std::fill(this->H.begin(), this->H.end(), 0.0);
      if (this->has_curvature) {
         this->hessian.reset();
         subproblem.compute_regularized_hessian(statistics, this->hessian);
         for (const auto [row, col, value] : this->hessian) {
            this->H[row * this->n + col] += value;
            if (row != col) { this->H[col * this->n + row] += value; }
         }
      }
      std::vector<double> vlb(this->n), vub(this->n);
      subproblem.set_variables_bounds(vlb, vub);
      for (size_t i = 0; i < this->n; ++i) {
         this->dl[i] = std::max(-ipqp::HUGE_BOUND, vlb[i]);
         this->du[i] = std::min(ipqp::HUGE_BOUND, vub[i]);
      }
      subproblem.set_constraints_bounds(this->rl, this->ru, this->constraints);
      for (size_t j = 0; j < this->m; ++j) {
         this->rl[j] = std::max(-ipqp::HUGE_BOUND, this->rl[j]);
         this->ru[j] = std::min(ipqp::HUGE_BOUND, this->ru[j]);
      }

      const ipqp::Result res = ipqp::solve(this->workspace, ni, mi,
         this->g.data(), this->H.data(), this->Jd.data(),
         this->rl.data(), this->ru.data(), this->dl.data(), this->du.data(),
         this->out_d.data(), this->out_y.data(), this->out_zl.data(),
         this->out_zu.data());

      direction.multipliers.reset();
      for (size_t i = 0; i < this->n; ++i) {
         direction.primals[i] = std::min(std::max(this->out_d[i], this->dl[i]), this->du[i]);
         direction.multipliers.lower_bounds[i] = this->out_zl[i];
         direction.multipliers.upper_bounds[i] = this->out_zu[i];
      }
      for (size_t j = 0; j < this->m; ++j) {
         direction.multipliers.constraints[j] = this->out_y[j];
      }
      direction.subproblem_objective = res.objective;
      switch (res.status) {
         case ipqp::Status::OPTIMAL: direction.status = SubproblemStatus::OPTIMAL; break;
         case ipqp::Status::INFEASIBLE: direction.status = SubproblemStatus::INFEASIBLE; break;
         case ipqp::Status::UNBOUNDED: direction.status = SubproblemStatus::UNBOUNDED_PROBLEM; break;
         default: direction.status = SubproblemStatus::ERROR; break;
      }
   }

   [[nodiscard]] double hessian_quadratic_product(const Vector<double>& vector) const override {
      double acc = 0.0;
      for (size_t i = 0; i < this->n; ++i) {
         double hv = 0.0;
         for (size_t k = 0; k < this->n; ++k) { hv += this->H[i * this->n + k] * vector[k]; }
         acc += vector[i] * hv;
      }
      return acc;
   }

private:
   size_t n{0}, m{0};
   bool has_curvature{false};
   Vector<double> g;
   std::vector<double> H, Jd, dl, du, rl, ru;
   std::vector<double> constraints;
   RectangularMatrix<double> constraint_jacobian;
   SparseSymmetricMatrix<COOFormat<size_t, double>> hessian{};
   std::vector<double> out_d, out_y, out_zl, out_zu;
   ipqp::Workspace workspace;
};

// factory overrides (linked before libuno.a, same trick as the linear
// solver below): any QP_solver/LP_solver name resolves to the IP-QP
std::unique_ptr<QPSolver> QPSolverFactory::create(const Options& /*options*/) {
   return std::make_unique<IPQPSolver>();
}

std::unique_ptr<LPSolver> LPSolverFactory::create(const Options& /*options*/) {
   return std::make_unique<IPQPSolver>();
}

// my factory replaces the reference's (same symbols, defined here and linked
// before libuno.a so its SymmetricIndefiniteLinearSolverFactory.cpp.o member
// never gets pulled in): every linear_solver name resolves to the LAPACK LDL^T
std::unique_ptr<DirectSymmetricIndefiniteLinearSolver<size_t, double>>
SymmetricIndefiniteLinearSolverFactory::create(const std::string& /*linear_solver*/) {
   return std::make_unique<LapackLDLTSolver>();
}

std::vector<std::string> SymmetricIndefiniteLinearSolverFactory::available_solvers() {
   return {"LAPACK"};
}

// ---------------------------------------------------------------------------
// Analytic models (hand-coded f/c/derivatives; no ASL in this container)
// ---------------------------------------------------------------------------
class AnalyticModel : public Model {
public:
   AnalyticModel(std::string name, size_t n, size_t m,
                 std::vector<double> xl, std::vector<double> xu,
                 std::vector<double> cl, std::vector<double> cu,
                 std::vector<double> x0)
      : Model(std::move(name), n, m, 1.0),
        xl_(std::move(xl)), xu_(std::move(xu)), cl_(std::move(cl)), cu_(std::move(cu)),
        x0_(std::move(x0)),
        lower_bounded_collection(lower_bounded), upper_bounded_collection(upper_bounded),
        single_lower_collection(single_lower), single_upper_collection(single_upper),
        equality_collection(equalities), inequality_collection(inequalities),
        linear_collection(linear_constraints) {
      for (size_t i = 0; i < n; ++i) {
         const bool lb = is_finite(xl_[i]), ub = is_finite(xu_[i]);
         if (lb) { lower_bounded.push_back(i); }
         if (ub) { upper_bounded.push_back(i); }
         if (lb && !ub) { single_lower.push_back(i); }
         if (ub && !lb) { single_upper.push_back(i); }
         if (lb && ub && xl_[i] == xu_[i]) { fixed_variables.push_back(i); }
      }
      for (size_t j = 0; j < m; ++j) {
         if (cl_[j] == cu_[j]) { equalities.push_back(j); }
         else { inequalities.push_back(j); }
      }
   }

   [[nodiscard]] double variable_lower_bound(size_t i) const override { return xl_[i]; }
   [[nodiscard]] double variable_upper_bound(size_t i) const override { return xu_[i]; }
   [[nodiscard]] double constraint_lower_bound(size_t j) const override { return cl_[j]; }
   [[nodiscard]] double constraint_upper_bound(size_t j) const override { return cu_[j]; }

   [[nodiscard]] const Collection<size_t>& get_lower_bounded_variables() const override { return lower_bounded_collection; }
   [[nodiscard]] const Collection<size_t>& get_upper_bounded_variables() const override { return upper_bounded_collection; }
   [[nodiscard]] const SparseVector<size_t>& get_slacks() const override { return slacks; }
   [[nodiscard]] const Collection<size_t>& get_single_lower_bounded_variables() const override { return single_lower_collection; }
   [[nodiscard]] const Collection<size_t>& get_single_upper_bounded_variables() const override { return single_upper_collection; }
   [[nodiscard]] const Vector<size_t>& get_fixed_variables() const override { return fixed_variables; }
   [[nodiscard]] const Collection<size_t>& get_equality_constraints() const override { return equality_collection; }
   [[nodiscard]] const Collection<size_t>& get_inequality_constraints() const override { return inequality_collection; }
   [[nodiscard]] const Collection<size_t>& get_linear_constraints() const override { return linear_collection; }

   void initial_primal_point(Vector<double>& x) const override {
      for (size_t i = 0; i < number_variables; ++i) { x[i] = x0_[i]; }
   }
   void initial_dual_point(Vector<double>& multipliers) const override {
      multipliers.fill(0.0);
   }
   void postprocess_solution(Iterate& /*iterate*/, IterateStatus /*status*/) const override {}

   // dense fallbacks; subclasses report exact sparsity if they want
   [[nodiscard]] size_t number_jacobian_nonzeros() const override {
      return number_constraints * number_variables;
   }
   [[nodiscard]] size_t number_hessian_nonzeros() const override {
      return number_variables * (number_variables + 1) / 2;
   }

   void compute_hessian_vector_product(const double* vector, double objective_multiplier,
         const Vector<double>& multipliers, double* result) const override {
      // dense reference implementation via evaluate_lagrangian_hessian is not
      // needed by the IPM path (ExactHessian is explicit-only); leave it out
      (void)vector; (void)objective_multiplier; (void)multipliers; (void)result;
      throw std::runtime_error("AnalyticModel: Hessian-vector products not implemented");
   }

   // helpers for subclasses: dense lower-level API
   virtual void dense_jacobian(const Vector<double>& x, std::vector<std::vector<double>>& J) const = 0;
   virtual void dense_hessian(const Vector<double>& x, double ow, const Vector<double>& y,
                              std::vector<std::vector<double>>& H) const = 0;

   void evaluate_constraint_gradient(const Vector<double>& x, size_t j,
         SparseVector<double>& gradient) const override {
      std::vector<std::vector<double>> J(number_constraints,
         std::vector<double>(number_variables, 0.0));
      dense_jacobian(x, J);
      gradient.clear();
      for (size_t i = 0; i < number_variables; ++i) {
         if (J[j][i] != 0.0) { gradient.insert(i, J[j][i]); }
      }
   }

   void evaluate_constraint_jacobian(const Vector<double>& x,
         RectangularMatrix<double>& constraint_jacobian) const override {
      std::vector<std::vector<double>> J(number_constraints,
         std::vector<double>(number_variables, 0.0));
      dense_jacobian(x, J);
      for (size_t j = 0; j < number_constraints; ++j) {
         constraint_jacobian[j].clear();
         for (size_t i = 0; i < number_variables; ++i) {
            if (J[j][i] != 0.0) { constraint_jacobian[j].insert(i, J[j][i]); }
         }
      }
   }

   // Lagrangian Hessian H = ow * H_f - sum_j y_j H_{c_j} (ASL lagscale -1
   // convention, AMPLModel.cpp:38-40); upper triangle inserted column-wise
   void evaluate_lagrangian_hessian(const Vector<double>& x, double objective_multiplier,
         const Vector<double>& multipliers, SymmetricMatrix<size_t, double>& hessian) const override {
      std::vector<std::vector<double>> H(number_variables,
         std::vector<double>(number_variables, 0.0));
      dense_hessian(x, objective_multiplier, multipliers, H);
      for (size_t col = 0; col < number_variables; ++col) {
         for (size_t row = 0; row <= col; ++row) {
            hessian.insert(row, col, H[row][col]);
         }
         hessian.finalize_column(col);
      }
   }

protected:
   std::vector<double> xl_, xu_, cl_, cu_, x0_;
   std::vector<size_t> lower_bounded, upper_bounded, single_lower, single_upper;
   std::vector<size_t> equalities, inequalities, linear_constraints;
   Vector<size_t> fixed_variables;
   SparseVector<size_t> slacks{};
   CollectionAdapter<std::vector<size_t>&> lower_bounded_collection, upper_bounded_collection;
   CollectionAdapter<std::vector<size_t>&> single_lower_collection, single_upper_collection;
   CollectionAdapter<std::vector<size_t>&> equality_collection, inequality_collection;
   CollectionAdapter<std::vector<size_t>&> linear_collection;
};

static const double INF_D = INF<double>;

// hs015 (examples/hs015.mod): min 100(x2-x1^2)^2 + (1-x1)^2
// s.t. x1*x2 >= 1; x1 + x2^2 >= 0; x1 <= 0.5; x0 = (-2, 1)
class Hs015 : public AnalyticModel {
public:
   Hs015() : AnalyticModel("hs015", 2, 2, {-INF_D, -INF_D}, {0.5, INF_D},
                           {1.0, 0.0}, {INF_D, INF_D}, {-2.0, 1.0}) {}

   [[nodiscard]] double evaluate_objective(const Vector<double>& x) const override {
      const double t = x[1] - x[0] * x[0];
      return 100.0 * t * t + (1.0 - x[0]) * (1.0 - x[0]);
   }
   void evaluate_objective_gradient(const Vector<double>& x, Vector<double>& g) const override {
      const double t = x[1] - x[0] * x[0];
      g[0] = -400.0 * t * x[0] - 2.0 * (1.0 - x[0]);
      g[1] = 200.0 * t;
   }
   void evaluate_constraints(const Vector<double>& x, std::vector<double>& c) const override {
      c[0] = x[0] * x[1];
      c[1] = x[0] + x[1] * x[1];
   }
   void dense_jacobian(const Vector<double>& x, std::vector<std::vector<double>>& J) const override {
      J[0][0] = x[1]; J[0][1] = x[0];
      J[1][0] = 1.0;  J[1][1] = 2.0 * x[1];
   }
   void dense_hessian(const Vector<double>& x, double ow, const Vector<double>& y,
                      std::vector<std::vector<double>>& H) const override {
      H[0][0] = ow * (1200.0 * x[0] * x[0] - 400.0 * x[1] + 2.0);
      H[0][1] = H[1][0] = ow * (-400.0 * x[0]) - y[0];
      H[1][1] = ow * 200.0 - y[1] * 2.0;
   }
};

// polak5 (examples/polak5.mod): min u s.t. -u + 3 x1^2 + 50 (x1 - x2^4 - 1)^2 <= 0,
//                                      -u + 3 x1^2 + 50 (x1 - x2^4 + 1)^2 <= 0
// variables (x1, x2, u), x0 = (0.1, 0.1, 0)
class Polak5 : public AnalyticModel {
public:
   Polak5() : AnalyticModel("polak5", 3, 2, {-INF_D, -INF_D, -INF_D},
                            {INF_D, INF_D, INF_D}, {-INF_D, -INF_D}, {0.0, 0.0},
                            {0.1, 0.1, 0.0}) {}

   [[nodiscard]] double evaluate_objective(const Vector<double>& x) const override {
      return x[2];
   }
   void evaluate_objective_gradient(const Vector<double>& /*x*/, Vector<double>& g) const override {
      g[0] = 0.0; g[1] = 0.0; g[2] = 1.0;
   }
   void evaluate_constraints(const Vector<double>& x, std::vector<double>& c) const override {
      const double t1 = x[0] - std::pow(x[1], 4) - 1.0;
      const double t2 = x[0] - std::pow(x[1], 4) + 1.0;
      c[0] = -x[2] + 3.0 * x[0] * x[0] + 50.0 * t1 * t1;
      c[1] = -x[2] + 3.0 * x[0] * x[0] + 50.0 * t2 * t2;
   }
   void dense_jacobian(const Vector<double>& x, std::vector<std::vector<double>>& J) const override {
      const double x2_3 = std::pow(x[1], 3);
      for (size_t j = 0; j < 2; ++j) {
         const double shift = (j == 0) ? -1.0 : 1.0;
         const double t = x[0] - std::pow(x[1], 4) + shift;
         J[j][0] = 6.0 * x[0] + 100.0 * t;
         J[j][1] = 100.0 * t * (-4.0 * x2_3);
         J[j][2] = -1.0;
      }
   }
   void dense_hessian(const Vector<double>& x, double /*ow*/, const Vector<double>& y,
                      std::vector<std::vector<double>>& H) const override {
      // objective is linear; constraints carry all curvature (note L = ow f - sum y_j c_j)
      const double x2_2 = x[1] * x[1], x2_3 = x2_2 * x[1], x2_6 = x2_3 * x2_3;
      for (size_t j = 0; j < 2; ++j) {
         const double shift = (j == 0) ? -1.0 : 1.0;
         const double t = x[0] - std::pow(x[1], 4) + shift;
         const double h00 = 6.0 + 100.0;
         const double h01 = 100.0 * (-4.0 * x2_3);
         const double h11 = 100.0 * 16.0 * x2_6 + 100.0 * t * (-12.0 * x2_2);
         H[0][0] += -y[j] * h00;
         H[0][1] += -y[j] * h01;
         H[1][1] += -y[j] * h11;
      }
      H[1][0] = H[0][1];
   }
};

// infeasible test problem: min x s.t. x^2 + 1 <= 0 (MOI.Test-style
// infeasibility detection probe)
class Infeas : public AnalyticModel {
public:
   Infeas() : AnalyticModel("infeas", 1, 1, {-INF_D}, {INF_D},
                            {-INF_D}, {0.0}, {1.0}) {}
   [[nodiscard]] double evaluate_objective(const Vector<double>& x) const override {
      return x[0];
   }
   void evaluate_objective_gradient(const Vector<double>& /*x*/, Vector<double>& g) const override {
      g[0] = 1.0;
   }
   void evaluate_constraints(const Vector<double>& x, std::vector<double>& c) const override {
      c[0] = x[0] * x[0] + 1.0;
   }
   void dense_jacobian(const Vector<double>& x, std::vector<std::vector<double>>& J) const override {
      J[0][0] = 2.0 * x[0];
   }
   void dense_hessian(const Vector<double>& /*x*/, double /*ow*/, const Vector<double>& y,
                      std::vector<std::vector<double>>& H) const override {
      H[0][0] = -y[0] * 2.0;
   }
};

// the bench flagship family (mirrors /root/repo/__graft_entry__._flagship):
// min sum((x-a)^2) + 0.1 sum(x[:-1] x[1:]) s.t. sum(x) >= 1, sum(x^2) <= 2, x >= 0
class Flagship : public AnalyticModel {
public:
   explicit Flagship(const std::vector<double>& a)
      : AnalyticModel("flagship", a.size(), 2,
                      std::vector<double>(a.size(), 0.0), std::vector<double>(a.size(), INF_D),
                      {1.0, -INF_D}, {INF_D, 2.0},
                      std::vector<double>(a.size(), 0.5)),
        a_(a) {}

   [[nodiscard]] double evaluate_objective(const Vector<double>& x) const override {
      double v = 0.0;
      for (size_t i = 0; i < number_variables; ++i) {
         const double d = x[i] - a_[i];
         v += d * d;
      }
      for (size_t i = 0; i + 1 < number_variables; ++i) { v += 0.1 * x[i] * x[i + 1]; }
      return v;
   }
   void evaluate_objective_gradient(const Vector<double>& x, Vector<double>& g) const override {
      for (size_t i = 0; i < number_variables; ++i) { g[i] = 2.0 * (x[i] - a_[i]); }
      for (size_t i = 0; i + 1 < number_variables; ++i) {
         g[i] += 0.1 * x[i + 1];
         g[i + 1] += 0.1 * x[i];
      }
   }
   void evaluate_constraints(const Vector<double>& x, std::vector<double>& c) const override {
      double s = 0.0, q = 0.0;
      for (size_t i = 0; i < number_variables; ++i) { s += x[i]; q += x[i] * x[i]; }
      c[0] = s; c[1] = q;
   }
   void dense_jacobian(const Vector<double>& x, std::vector<std::vector<double>>& J) const override {
      for (size_t i = 0; i < number_variables; ++i) {
         J[0][i] = 1.0;
         J[1][i] = 2.0 * x[i];
      }
   }
   void dense_hessian(const Vector<double>& /*x*/, double ow, const Vector<double>& y,
                      std::vector<std::vector<double>>& H) const override {
      for (size_t i = 0; i < number_variables; ++i) {
         H[i][i] = ow * 2.0 - y[1] * 2.0;
         if (i + 1 < number_variables) { H[i][i + 1] = H[i + 1][i] = ow * 0.1; }
      }
   }

private:
   std::vector<double> a_;
};

// ---------------------------------------------------------------------------
// .nl-file model: ASL replacement via the in-repo .nl parser + postfix AD
// (postfix_ad.hpp).  Lets the REFERENCE driver sweep the same corpus the
// JAX framework solves (round-4: reference-side parity denominator).
// Mirrors the seam of bindings/AMPL/AMPLModel.cpp:19-80.
// ---------------------------------------------------------------------------
struct NLParsed {
   std::string name;
   size_t n, m;
   std::vector<double> xl, xu, cl, cu, x0;
   nlad::Prog obj;
   std::vector<nlad::Prog> cons;
   // linear parts (.nl J/G sections add to the nonlinear expressions)
   std::vector<std::pair<size_t, double>> obj_lin;
   std::vector<std::vector<std::pair<size_t, double>>> con_lin;
};

inline NLParsed parse_nl_file(const std::string& path) {
   NLData* d = nl_parse(path.c_str());
   if (d == nullptr) { throw std::runtime_error("nl_parse returned null"); }
   std::string err(d->error);
   if (!err.empty()) { nl_free(d); throw std::runtime_error("parse " + path + ": " + err); }
   if (d->n_defined > 0) {
      nl_free(d);
      throw std::runtime_error(path + ": defined variables unsupported in baseline bridge");
   }
   if (d->objective_sense != 0) {
      nl_free(d);
      throw std::runtime_error(path + ": maximization unsupported in baseline bridge");
   }
   NLParsed out;
   out.n = static_cast<size_t>(d->n_vars);
   out.m = static_cast<size_t>(d->n_cons);
   out.xl.assign(d->x_lb, d->x_lb + out.n);
   out.xu.assign(d->x_ub, d->x_ub + out.n);
   out.cl.assign(d->c_lb, d->c_lb + out.m);
   out.cu.assign(d->c_ub, d->c_ub + out.m);
   out.x0.assign(d->x0, d->x0 + out.n);
   const int32_t o0 = d->obj_expr_off[0], o1 = d->obj_expr_off[1];
   out.obj = nlad::decode(d->tok_op + o0, d->tok_num + o0, o1 - o0);
   out.cons.resize(out.m);
   out.con_lin.resize(out.m);
   for (size_t j = 0; j < out.m; ++j) {
      const int32_t c0 = d->con_expr_off[j], c1 = d->con_expr_off[j + 1];
      out.cons[j] = nlad::decode(d->tok_op + c0, d->tok_num + c0, c1 - c0);
   }
   for (int32_t k = 0; k < d->jac_nnz; ++k) {
      if (d->jac_val[k] != 0.0) {
         out.con_lin[d->jac_row[k]].emplace_back(d->jac_col[k], d->jac_val[k]);
      }
   }
   for (int32_t k = 0; k < d->grad_nnz; ++k) {
      if (d->grad_val[k] != 0.0) {
         out.obj_lin.emplace_back(d->grad_col[k], d->grad_val[k]);
      }
   }
   nl_free(d);
   return out;
}

class NLFileModel : public AnalyticModel {
public:
   explicit NLFileModel(NLParsed parsed)
      : AnalyticModel(parsed.name, parsed.n, parsed.m, parsed.xl, parsed.xu,
                      parsed.cl, parsed.cu, parsed.x0),
        p_(std::move(parsed)) {}

   [[nodiscard]] double evaluate_objective(const Vector<double>& x) const override {
      nlad::forward(p_.obj, x.data(), -1);
      double v = p_.obj.val[p_.obj.root];
      for (const auto& [col, cv] : p_.obj_lin) { v += cv * x[col]; }
      return v;
   }
   void evaluate_objective_gradient(const Vector<double>& x, Vector<double>& g) const override {
      g.fill(0.0);
      nlad::forward(p_.obj, x.data(), -1);
      nlad::reverse(p_.obj, 1.0, g.data(), false, nullptr);
      for (const auto& [col, cv] : p_.obj_lin) { g[col] += cv; }
   }
   void evaluate_constraints(const Vector<double>& x, std::vector<double>& c) const override {
      for (size_t j = 0; j < p_.m; ++j) {
         nlad::forward(p_.cons[j], x.data(), -1);
         double v = p_.cons[j].val[p_.cons[j].root];
         for (const auto& [col, cv] : p_.con_lin[j]) { v += cv * x[col]; }
         c[j] = v;
      }
   }
   void dense_jacobian(const Vector<double>& x, std::vector<std::vector<double>>& J) const override {
      for (size_t j = 0; j < p_.m; ++j) {
         nlad::forward(p_.cons[j], x.data(), -1);
         nlad::reverse(p_.cons[j], 1.0, J[j].data(), false, nullptr);
         for (const auto& [col, cv] : p_.con_lin[j]) { J[j][col] += cv; }
      }
   }
   // H = ow * H_f - sum_j y_j H_{c_j} (ASL lagscale -1 convention) by
   // forward-over-reverse Hessian-vector products over each expression's
   // variable support (one tangent direction per column)
   void dense_hessian(const Vector<double>& x, double ow, const Vector<double>& y,
                      std::vector<std::vector<double>>& H) const override {
      hv_.assign(p_.n, 0.0);
      auto accumulate = [&](const nlad::Prog& prog, double weight) {
         if (weight == 0.0) { return; }
         for (const int32_t col : prog.vars) {
            nlad::forward(prog, x.data(), col);
            std::fill(hv_.begin(), hv_.end(), 0.0);
            nlad::reverse(prog, weight, nullptr, true, hv_.data());
            for (const int32_t row : prog.vars) {
               H[row][col] += hv_[row];
            }
         }
      };
      accumulate(p_.obj, ow);
      for (size_t j = 0; j < p_.m; ++j) { accumulate(p_.cons[j], -y[j]); }
   }

private:
   NLParsed p_;
   mutable std::vector<double> hv_;
};

// ---------------------------------------------------------------------------
// driver
// ---------------------------------------------------------------------------
struct SolveOutcome {
   OptimizationStatus status;
   IterateStatus iterate_status;
   size_t iterations;
   double objective;
   double time_s;
};

SolveOutcome run_once(std::unique_ptr<Model> analytic_model, const Options& options,
                      bool print_summary) {
   std::unique_ptr<Model> model = ModelFactory::reformulate(std::move(analytic_model), options);
   Iterate initial_iterate(model->number_variables, model->number_constraints);
   model->initial_primal_point(initial_iterate.primals);
   model->project_onto_variable_bounds(initial_iterate.primals);
   model->initial_dual_point(initial_iterate.multipliers.constraints);
   initial_iterate.feasibility_multipliers.reset();

   Uno uno{model->number_constraints, options};
   const auto t0 = std::chrono::steady_clock::now();
   Result result = uno.solve(*model, initial_iterate, options);
   const auto t1 = std::chrono::steady_clock::now();
   if (print_summary) {
      uno.print_optimization_summary(result);
   }
   return {result.optimization_status, result.solution.status, result.iteration,
           result.solution.evaluations.objective,
           std::chrono::duration<double>(t1 - t0).count()};
}

}  // namespace uno

int main(int argc, char* argv[]) {
   using namespace uno;
   if (argc < 2) {
      std::cerr << "usage: uno_baseline <hs015|polak5|flagship|flagship_bench N> [key=value ...]\n";
      return 1;
   }
   const std::string which = argv[1];
   int arg_start = 2;
   size_t n_instances = 1;
   if (which == "flagship_bench" && argc >= 3 && std::isdigit(argv[2][0])) {
      n_instances = static_cast<size_t>(std::stoul(argv[2]));
      arg_start = 3;
   }
   if ((which == "nlfile" || which == "nlcheck" || which == "nlsweep")
       && argc >= 3) {
      arg_start = 3;   // argv[2] is a path, not a key=value option
   }

   Options options = DefaultOptions::load();
   options.overwrite_with(DefaultOptions::determine_solvers());
   Options command_line_options = Options::get_command_line_options(argc, argv, arg_start);
   const auto optional_preset = command_line_options.get_string_optional("preset");
   options.overwrite_with(Presets::get_preset_options(optional_preset));
   options.overwrite_with(command_line_options);
   Logger::set_logger(options.get_string("logger"));

   if (which == "hs015" || which == "polak5" || which == "flagship" || which == "infeas") {
      std::unique_ptr<Model> model;
      if (which == "hs015") { model = std::make_unique<Hs015>(); }
      else if (which == "infeas") { model = std::make_unique<Infeas>(); }
      else if (which == "polak5") { model = std::make_unique<Polak5>(); }
      else {
         std::mt19937_64 rng(0);
         std::uniform_real_distribution<double> dist(-0.5, 1.0);
         std::vector<double> a(8);
         for (auto& v : a) { v = dist(rng); }
         model = std::make_unique<Flagship>(a);
      }
      const auto out = run_once(std::move(model), options, true);
      std::cout << "RESULT problem=" << which
                << " status=" << static_cast<int>(out.status)
                << " iterate_status=" << static_cast<int>(out.iterate_status)
                << " iterations=" << out.iterations
                << " objective=" << out.objective
                << " time_s=" << out.time_s << "\n";
      return 0;
   }

   if (which == "nlfile" && argc >= 3) {
      // solve a single .nl file through the REFERENCE driver
      auto model = std::make_unique<NLFileModel>(parse_nl_file(argv[2]));
      const auto out = run_once(std::move(model), options, true);
      std::cout << "RESULT problem=" << std::filesystem::path(argv[2]).stem().string()
                << " status=" << static_cast<int>(out.status)
                << " iterate_status=" << static_cast<int>(out.iterate_status)
                << " iterations=" << out.iterations
                << " objective=" << out.objective
                << " time_s=" << out.time_s << "\n";
      return 0;
   }

   if (which == "nlcheck" && argc >= 3) {
      // print f/grad/c/J/H at x0 (for cross-validation against JAX)
      NLParsed parsed = parse_nl_file(argv[2]);
      NLFileModel model(parsed);
      Vector<double> x(model.number_variables);
      model.initial_primal_point(x);
      std::cout.precision(17);
      std::cout << "f " << model.evaluate_objective(x) << "\n";
      Vector<double> g(model.number_variables);
      model.evaluate_objective_gradient(x, g);
      std::cout << "g";
      for (size_t i = 0; i < model.number_variables; ++i) { std::cout << " " << g[i]; }
      std::cout << "\n";
      if (model.number_constraints > 0) {
         std::vector<double> c(model.number_constraints);
         model.evaluate_constraints(x, c);
         std::cout << "c";
         for (const double v : c) { std::cout << " " << v; }
         std::cout << "\n";
         std::vector<std::vector<double>> J(model.number_constraints,
            std::vector<double>(model.number_variables, 0.0));
         model.dense_jacobian(x, J);
         for (size_t j = 0; j < model.number_constraints; ++j) {
            std::cout << "J" << j;
            for (const double v : J[j]) { std::cout << " " << v; }
            std::cout << "\n";
         }
      }
      std::vector<std::vector<double>> H(model.number_variables,
         std::vector<double>(model.number_variables, 0.0));
      Vector<double> y(std::max<size_t>(model.number_constraints, 1));
      for (size_t j = 0; j < model.number_constraints; ++j) {
         y[j] = 0.1 * static_cast<double>(j + 1);
      }
      model.dense_hessian(x, 1.0, y, H);
      for (size_t i = 0; i < model.number_variables; ++i) {
         std::cout << "H" << i;
         for (const double v : H[i]) { std::cout << " " << v; }
         std::cout << "\n";
      }
      return 0;
   }

   if (which == "nlsweep" && argc >= 3) {
      // sweep every .nl file in a directory with the current options;
      // one JSON line per problem (consumed by tools/refparity.py)
      std::vector<std::filesystem::path> files;
      for (const auto& entry : std::filesystem::directory_iterator(argv[2])) {
         if (entry.path().extension() == ".nl") { files.push_back(entry.path()); }
      }
      std::sort(files.begin(), files.end());
      for (const auto& file : files) {
         std::string name = file.stem().string();
         try {
            auto model = std::make_unique<NLFileModel>(parse_nl_file(file.string()));
            const auto out = run_once(std::move(model), options, false);
            std::cout << "{\"name\": \"" << name << "\", \"status\": "
                      << static_cast<int>(out.status)
                      << ", \"iterate_status\": " << static_cast<int>(out.iterate_status)
                      << ", \"iterations\": " << out.iterations
                      << ", \"objective\": ";
            if (std::isfinite(out.objective)) { std::cout << out.objective; }
            else { std::cout << "null"; }
            std::cout << ", \"time_s\": " << out.time_s << "}" << std::endl;
         }
         catch (const std::exception& e) {
            std::cout << "{\"name\": \"" << name << "\", \"status\": -1, "
                      << "\"error\": \"" << e.what() << "\"}" << std::endl;
         }
      }
      return 0;
   }

   if (which == "qptest") {
      // standalone IP-QP kernel probes with known solutions
      auto runqp = [&](int n, int m, std::vector<double> g, std::vector<double> H,
                       std::vector<double> J, std::vector<double> rl, std::vector<double> ru,
                       std::vector<double> dl, std::vector<double> du) {
         ipqp::Workspace W;
         std::vector<double> d(n), y(std::max(m, 1)), zl(n), zu(n);
         const auto res = ipqp::solve(W, n, m, g.data(), H.data(), J.data(),
            rl.data(), ru.data(), dl.data(), du.data(),
            d.data(), y.data(), zl.data(), zu.data());
         std::cout.precision(12);
         std::cout << "status=" << static_cast<int>(res.status)
                   << " it=" << res.iterations << " obj=" << res.objective << "\nd:";
         for (double v : d) { std::cout << " " << v; }
         std::cout << "\ny:";
         for (int j = 0; j < m; ++j) { std::cout << " " << y[j]; }
         std::cout << "\nzl:";
         for (double v : zl) { std::cout << " " << v; }
         std::cout << "\nzu:";
         for (double v : zu) { std::cout << " " << v; }
         std::cout << "\n";
      };
      const double NB = 1e30;
      std::cout << "-- QP1: min -d1 + 0.5(d1^2+d2^2), d1+d2 <= 1, d >= 0 (d*=(1,0))\n";
      runqp(2, 1, {-1, 0}, {1, 0, 0, 1}, {1, 1}, {-NB}, {1}, {0, 0}, {NB, NB});
      std::cout << "-- QP2: min g'd + 0.5 d'Hd free (Newton step)\n";
      runqp(2, 0, {1, -2}, {2, 0, 0, 4}, {}, {}, {}, {-NB, -NB}, {NB, NB});
      std::cout << "-- QP3: equality d1+d2 = 1, min 0.5||d||^2 (d*=(0.5,0.5), y=0.5)\n";
      runqp(2, 1, {0, 0}, {1, 0, 0, 1}, {1, 1}, {1}, {1}, {-NB, -NB}, {NB, NB});
      std::cout << "-- QP4: infeasible: d <= -1 and d >= 1 rows\n";
      runqp(1, 2, {0}, {1}, {1, 1}, {-NB, 1}, {-1, NB}, {-NB}, {NB});
      std::cout << "-- QP5: nonconvex H with TR box (convexified)\n";
      runqp(2, 0, {1, 1}, {-2, 0, 0, -2}, {}, {}, {}, {-1, -1}, {1, 1});
      std::cout << "-- QP6: hs015-at-opt: quadratic model at x*, small TR\n";
      return 0;
   }

   if (which == "flagship_bench") {
      // sequential single-core solves over the same randomized family the JAX
      // bench uses (__graft_entry__._flagship with rng seed 0): a MEASURED
      // single-core Uno solves/s figure for BASELINE.md.  vars=N (default 8)
      // gives the mid-size (n=128...) baseline the n-throughput curve needs.
      const size_t nvars = static_cast<size_t>(
         options.get_string_optional("vars") ? std::stoul(*options.get_string_optional("vars")) : 8);
      std::mt19937_64 rng(0);
      std::uniform_real_distribution<double> dist(-0.5, 1.0);
      size_t solved = 0, total_iters = 0;
      // warmup instance (excluded from timing)
      {
         std::vector<double> a(nvars);
         for (auto& v : a) { v = dist(rng); }
         run_once(std::make_unique<Flagship>(a), options, false);
      }
      const auto t0 = std::chrono::steady_clock::now();
      for (size_t inst = 0; inst < n_instances; ++inst) {
         std::vector<double> a(nvars);
         for (auto& v : a) { v = dist(rng); }
         const auto out = run_once(std::make_unique<Flagship>(a), options, false);
         if (out.status == OptimizationStatus::SUCCESS &&
             (out.iterate_status == IterateStatus::FEASIBLE_KKT_POINT ||
              out.iterate_status == IterateStatus::FEASIBLE_SMALL_STEP)) {
            solved++;
         }
         total_iters += out.iterations;
      }
      const auto t1 = std::chrono::steady_clock::now();
      const double wall = std::chrono::duration<double>(t1 - t0).count();
      std::cout << "BENCH instances=" << n_instances << " solved=" << solved
                << " wall_s=" << wall
                << " solves_per_sec=" << (static_cast<double>(n_instances) / wall)
                << " mean_iterations=" << (static_cast<double>(total_iters) / static_cast<double>(n_instances))
                << "\n";
      return 0;
   }

   std::cerr << "unknown problem " << which << "\n";
   return 1;
}
