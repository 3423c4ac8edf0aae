from setuptools import find_packages, setup

setup(
    name="fashionvisualexpl-tpu",
    version="0.1.0",
    description="TPU-native visual recommender framework (JAX/XLA/Pallas)",
    packages=find_packages(exclude=("tests",)),
    # the PyTorch port's CUDA kernel sources, compiled with nvcc at first
    # use, and its host library's source, compiled with g++ at first use
    package_data={"fashionvisualexpl_tpu_torch": ["ops/csrc/*.cu", "data/csrc/*.cpp"]},
    python_requires=">=3.10",
)
