from gnn_computing_tpu_torch.utils.cli import main

if __name__ == "__main__":
    main()
