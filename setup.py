from setuptools import find_packages, setup

setup(
    name="grounded_video_description_tpu",
    version="0.1.0",
    description="TPU-native grounded video description framework "
                "(JAX/XLA/Pallas)",
    packages=find_packages(
        include=["grounded_video_description_tpu",
                 "grounded_video_description_tpu.*",
                 "grounded_video_description_torch",
                 "grounded_video_description_torch.*"]),
    py_modules=["main"],
    package_data={
        "grounded_video_description_tpu.data": ["native/pack.cc",
                                                "native/Makefile"],
        # the PyTorch port's CUDA kernels, built with nvcc at first use
        "grounded_video_description_torch": ["csrc/*.cu", "csrc/*.cuh"],
        # its host batch packer, built with the C++ compiler at first use
        "grounded_video_description_torch.data": ["native/pack.cc"],
    },
    python_requires=">=3.10",
    install_requires=["jax", "optax", "orbax-checkpoint", "numpy",
                      "pyyaml", "h5py"],
    entry_points={
        "console_scripts": ["gvd-tpu=main:main"],
    },
)
