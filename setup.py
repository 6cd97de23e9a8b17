from setuptools import find_packages, setup

from luminoth_tpu.version import __version__

setup(
    name="luminoth-tpu",
    version=__version__,
    description="TPU-native computer vision toolkit (object detection)",
    packages=find_packages(exclude=["tests", "tests.*"]),
    include_package_data=True,
    package_data={
        "luminoth_tpu": ["models/*/base_config.yml", "native/*.c",
                         "tools/server/templates/*", "tools/server/static/*"],
        "luminoth_tpu_torch": ["csrc/*.cu", "models/*/base_config.yml",
                               "native/*.c", "tools/server/templates/*"],
    },
    install_requires=[
        "jax",
        "flax",
        "optax",
        "numpy",
        "click",
        "PyYAML",
        "Pillow",
    ],
    entry_points={
        "console_scripts": ["lumi=luminoth_tpu.cli:cli"],
    },
    python_requires=">=3.10",
)
