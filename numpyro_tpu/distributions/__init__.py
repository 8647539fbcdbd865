"""numpyro_tpu.distributions — accelerator-native distributions library (L1).

API parity target: numpyro/distributions/__init__.py:114-215. The public
inventory is declared as a per-module name table and materialised into the
package namespace in one pass.
"""

from importlib import import_module

from . import constraints, transforms
from .distribution import (
    DistributionLike,
    enable_validation,
    validation_enabled,
)
from .kl import kl_divergence, register_kl
from .transforms import biject_to

_INVENTORY = {
    "continuous": """
        AsymmetricLaplace AsymmetricLaplaceQuantile Beta BetaProportion CAR
        Cauchy Chi2 CirculantNormal Dirichlet EulerMaruyama Exponential Gamma
        GaussianRandomWalk GaussianStateSpace Gompertz Gumbel HalfCauchy
        HalfNormal InverseGamma Kumaraswamy Laplace Levy LKJ LKJCholesky
        Logistic LogNormal LogUniform LowRankMultivariateNormal MatrixNormal
        MultivariateNormal MultivariateStudentT Normal Pareto RelaxedBernoulli
        RelaxedBernoulliLogits SoftLaplace StudentT Uniform Weibull Wishart
        WishartCholesky ZeroSumNormal
    """,
    "discrete": """
        Bernoulli BernoulliLogits BernoulliProbs Binomial BinomialLogits
        BinomialProbs Categorical CategoricalLogits CategoricalProbs
        DiscreteUniform Geometric GeometricLogits GeometricProbs Multinomial
        MultinomialLogits MultinomialProbs NegativeBinomial2 OrderedLogistic
        Poisson ZeroInflatedDistribution ZeroInflatedLogits
        ZeroInflatedNegativeBinomial2 ZeroInflatedPoisson ZeroInflatedProbs
    """,
    "distribution": """
        Delta Distribution ExpandedDistribution FoldedDistribution
        ImproperUniform Independent MaskedDistribution TransformedDistribution
        Unit
    """,
    "truncated": """
        DoublyTruncatedPowerLaw LeftTruncatedDistribution
        LowerTruncatedPowerLaw RightTruncatedDistribution TruncatedCauchy
        TruncatedDistribution TruncatedNormal TruncatedPolyaGamma
        TwoSidedTruncatedDistribution
    """,
    "directional": "ProjectedNormal SineBivariateVonMises SineSkewed VonMises",
    "conjugate": """
        BetaBinomial DirichletMultinomial GammaPoisson NegativeBinomial
        NegativeBinomialLogits NegativeBinomialProbs
    """,
    "copula": "GaussianCopula GaussianCopulaBeta",
    "mixtures": "Mixture MixtureGeneral MixtureSameFamily",
}

__all__ = [
    "biject_to", "constraints", "DistributionLike", "enable_validation",
    "kl_divergence", "register_kl", "transforms", "validation_enabled",
]
for _mod_name, _names in _INVENTORY.items():
    _mod = import_module(f".{_mod_name}", __name__)
    for _name in _names.split():
        globals()[_name] = getattr(_mod, _name)
        __all__.append(_name)
__all__.sort(key=str.lower)
del _mod_name, _names, _mod, _name
