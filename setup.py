from setuptools import find_packages, setup

setup(
    name="paddle_sparse_tpu",
    version="0.1.0",
    description="TPU-native sparse linear-algebra framework (JAX/XLA/Pallas)",
    packages=find_packages(include=["paddle_sparse_tpu*",
                                    "paddle_sparse_tpu_torch*"]),
    package_data={"paddle_sparse_tpu_torch": ["csrc/*.cu"]},
    python_requires=">=3.10",
    install_requires=["jax", "numpy", "scipy"],
)
