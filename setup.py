from setuptools import find_packages, setup

with open("README.md") as f:
    long_description = f.read()

setup(
    name="tinycarlo-tpu",
    version="2.0.0",
    description=(
        "TPU-native 2D self-driving-car simulation and training framework "
        "(JAX/Pallas), API-compatible with tinycarlo"
    ),
    long_description=long_description,
    long_description_content_type="text/markdown",
    license="MIT",
    packages=find_packages(include=[
        "tinycarlo_tpu", "tinycarlo_tpu.*",
        "tinycarlo_torch", "tinycarlo_torch.*",
    ]),
    package_data={
        "tinycarlo_tpu.models": ["pretrained/*.npz"],
        "tinycarlo_torch.ops": ["csrc/*.cu", "csrc/*.cuh"],
    },
    python_requires=">=3.10",
    install_requires=[
        "jax>=0.4.30",
        "flax>=0.8",
        "optax>=0.2",
        "numpy>=1.22",
        "pyyaml>=6.0",
    ],
    extras_require={
        "gym": ["gymnasium>=0.26"],
        "viz": ["opencv-python>=4.5.5", "matplotlib"],
        "checkpoint": ["orbax-checkpoint"],
        "testing": ["pytest", "torch"],
    },
    entry_points={
        "console_scripts": [
            "tinycarlo-tpu.mapbuilder=tinycarlo_tpu.mapbuilder.__main__:main",
        ],
    },
)
