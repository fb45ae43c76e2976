from setuptools import setup, find_packages

setup(
    name='se3-transformer-tpu',
    packages=find_packages(exclude=('tests',)),
    # the port's so2 canonical blocks: read before any Q_J construction
    package_data={'se3_transformer_torch.so2': ['_canonical_seed.npz']},
    version='0.1.0',
    license='MIT',
    description='SE(3)-Transformer — TPU-native JAX/XLA/Pallas implementation',
    python_requires='>=3.10',
    install_requires=[
        'jax',
        'flax',
        'optax',
        'einops>=0.3',
        'numpy',
        'scipy',
    ],
    extras_require={
        'test': ['pytest', 'orbax-checkpoint'],
        'checkpoint': ['orbax-checkpoint'],
        # the PyTorch/CUDA port (se3_transformer_torch)
        'torch': ['torch'],
    },
)
