from setuptools import setup, find_packages

setup(
    name='amt-tools-tpu',
    version='0.1.0',
    description='TPU-native automatic music transcription framework (JAX/XLA/Pallas)',
    packages=find_packages(exclude=['tests', 'examples']),
    # The PyTorch/CUDA port compiles its kernel sources at first use
    package_data={'amt_tools_tpu_torch': ['csrc/*.cu']},
    python_requires='>=3.10',
    install_requires=[
        'numpy',
        'scipy',
        'jax',
        'flax',
        'optax',
        'orbax-checkpoint',
    ],
    extras_require={
        'data': ['pandas', 'requests'],
        'viz': ['matplotlib'],
        'logging': ['tensorboardX'],
        'realtime': ['sounddevice', 'pynput'],
    },
)
