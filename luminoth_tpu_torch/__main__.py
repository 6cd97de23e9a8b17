from luminoth_tpu_torch.cli import cli

if __name__ == "__main__":
    cli()
