import sys

from repro_torch.analysis.lint.cli import main

if __name__ == "__main__":      # importing the package's modules runs nothing
    sys.exit(main())
